// Six off-diagonal Gaussian-kernel means of two score matrices, for the
// repulsive MMD losses 'rep' and 'rmb', and their gradient.
//
// Given generated scores sg and real scores sx, both fp32 [B, d] row-major,
// kernel_means_fwd writes
//   out[6] = (e_kxx, e_kxy, e_kyy, e_kxx_b, e_kxy_b, e_kyy_b)
// where xx = gen-gen, xy = gen-data, yy = data-data,
//   D_ij     = max(|a_i|^2 - 2 a_i.b_j + |b_j|^2, 0)
//   k        = exp(-D * inv2s2)
//   k_xx_b   = exp(-max(D_xx, lb) * inv2s2)   (gen-gen, lower-bounded)
//   k_yy_b   = exp(-min(D_yy, ub) * inv2s2)   (data-data, upper-bounded)
//   k_xy_b   = k_xy                           (repulsive direction)
// and every mean is the sum over i != j divided by N = B(B-1).
// kernel_means_bwd takes the cotangent ct[6] of those means and writes the
// gradients of <ct, out> with respect to sg and sx.
//
// Both kernels take the same pieces: 32 x 32 tiles of the three matrices,
// the symmetric ones above the diagonal only, one 256-thread block each.
// A block stages its row and column scores in shared memory in chunks of
// 32 features (any B >= 2 and d >= 1 fit) and forms the dot products with
// plain fp32 FMAs. No TF32 and no tensor cores: the reference computes
// these Gram matrices at full fp32 precision, and TF32 would move raw
// distances across the masks of the backward.
//
// What bounds the forward on an H100: at the main path's B=64, d=16 it
// reads 8,192 bytes and needs 8,128 Gram entries of depth 16 (B(B-1)/2 of
// each symmetric matrix, B^2 of gen-data), about 0.3 MFLOP and one
// exponential per entry. That is a few nanoseconds of memory, fp32 or
// special-function time, while one launch takes microseconds: launches and
// the host's cost per call set its time, so each direction is one launch
// with no host synchronisation, no allocation and no atomics on floats.
// The backward's own note stands above it.

#include <algorithm>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // rows and columns of a block's tile
constexpr int kChunk = 32;                // features staged per pass
constexpr int kThreads = 256;             // 8 warps
constexpr int kRowStep = kThreads / kTile;            // 8
constexpr int kRowsPerThread = kTile / kRowStep;      // 4
constexpr int kOutputs = 6;

__host__ __device__ inline int num_tiles(int batch) { return (batch + kTile - 1) / kTile; }

// Blocks of the forward: the t(t+1)/2 upper tiles of gen-gen, the t^2
// tiles of gen-data, the t(t+1)/2 upper tiles of data-data.
int forward_blocks(int tiles) { return tiles * (tiles + 1) + tiles * tiles; }

// Tickets of the forward's finishing block, one counter per device (a
// __device__ variable lives once in each context that loads this library).
__device__ unsigned int g_forward_ticket = 0;

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The (row, column) tile of the q-th upper tile, row <= column, in row order.
__device__ __forceinline__ void upper_tile(int q, int tiles, int* ty, int* tx) {
  int r = 0;
  while (q >= tiles - r) {
    q -= tiles - r;
    ++r;
  }
  *ty = r;
  *tx = r + q;
}

// The Gram entries of rows row0.. of `a` against rows col0.. of `b`: on
// return acc[i] = a_{row0 + ty + 8i} . b_{col0 + tx} (ty = threadIdx.x / 32,
// tx = threadIdx.x % 32), norm_a and norm_b hold the tile's squared row
// norms, and zero for rows at or past `batch`. Ends with __syncthreads().
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ a, const float* __restrict__ b, int row0, int col0,
    int batch, int dim, float (*ta)[kChunk + 1], float (*tb)[kChunk + 1],
    float* norm_a, float* norm_b, float acc[kRowsPerThread]) {
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  float norm = 0.f;   // threads 0..31: |a_row|^2, threads 32..63: |b_col|^2
  for (int k0 = 0; k0 < dim; k0 += kChunk) {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int k = e % kChunk;
      const int gk = k0 + k;
      const int ra = row0 + r;
      const int rb = col0 + r;
      ta[r][k] = (ra < batch && gk < dim) ? a[(size_t)ra * dim + gk] : 0.f;
      tb[r][k] = (rb < batch && gk < dim) ? b[(size_t)rb * dim + gk] : 0.f;
    }
    __syncthreads();
    const int kn = min(kChunk, dim - k0);
    if (threadIdx.x < kTile) {
      for (int k = 0; k < kn; ++k) norm = fmaf(ta[tx][k], ta[tx][k], norm);
    } else if (threadIdx.x < 2 * kTile) {
      for (int k = 0; k < kn; ++k) norm = fmaf(tb[tx][k], tb[tx][k], norm);
    }
    for (int k = 0; k < kn; ++k) {
      const float bv = tb[tx][k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(ta[ty + i * kRowStep][k], bv, acc[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x < kTile) {
    norm_a[tx] = norm;
  } else if (threadIdx.x < 2 * kTile) {
    norm_b[tx] = norm;
  }
  __syncthreads();
}

// Forward. Replaces mmdgan_tpu/ops/pallas_mmd.py::_kernel_means_kernel, the
// Pallas TPU kernel launched by _kernel_means, which held the whole B x B
// problem in one VMEM block.
//
// One launch of forward_blocks(t) blocks (10 at B=64). A linear block index
// maps onto the upper tiles of gen-gen, every tile of gen-data and the
// upper tiles of data-data: the two symmetric matrices are summed over
// i < j (their diagonal tiles keep row < column) and doubled at the end, so
// no block is launched for a mirror tile. A bounded kernel is a select
// against the constant exp(-bound * inv2s2), not a second exponential.
// Each block reduces its tile in a fixed order and writes two partial sums
// (plain, bounded) to partials[2 * block]; then it takes a ticket from
// g_forward_ticket with one release-acquire atomic (two __threadfence()
// calls around a relaxed atomicAdd cost more on the card: the finishing
// step is on the kernel's critical path). The block that draws the last
// ticket adds every block's partials in block order, whichever block that
// is, writes out[6] and resets the counter to 0, so the means are bitwise
// the same from run to run and a CUDA graph can replay the launch. The
// counter admits one launch in flight per device at a time: launches on
// one stream, as the train step makes them, are safe; two concurrent
// launches on two streams of one device are not. A launch that faults
// mid-way leaves the counter wrong, as a fault leaves the context anyway.
//
// Against the two launches it replaces (a tile pass and a one-block
// finishing pass), the device time inside a CUDA graph is about the same:
// the ticket's round trip to L2 costs what the kernel boundary did. The
// saving is one launch of host work per call on the eager step.
__global__ void __launch_bounds__(kThreads)
kernel_means_fwd(const float* __restrict__ sg, const float* __restrict__ sx,
                 float* __restrict__ partials, float* __restrict__ out, int batch,
                 int dim, float inv2s2, float lower, float upper) {
  const int tiles = num_tiles(batch);
  const int n_sym = tiles * (tiles + 1) / 2;
  const int block = blockIdx.x;
  int pair, tile_r, tile_c;
  if (block < n_sym) {
    pair = 0;
    upper_tile(block, tiles, &tile_r, &tile_c);
  } else if (block < n_sym + tiles * tiles) {
    pair = 1;
    tile_r = (block - n_sym) / tiles;
    tile_c = (block - n_sym) % tiles;
  } else {
    pair = 2;
    upper_tile(block - n_sym - tiles * tiles, tiles, &tile_r, &tile_c);
  }
  const float* __restrict__ a = pair == 2 ? sx : sg;   // rows
  const float* __restrict__ b = pair == 0 ? sg : sx;   // columns
  const int row0 = tile_r * kTile;
  const int col0 = tile_c * kTile;
  const bool symmetric = pair != 1;

  __shared__ float ta[kTile][kChunk + 1];   // +1: conflict-free column reads
  __shared__ float tb[kTile][kChunk + 1];
  __shared__ float norm_a[kTile];
  __shared__ float norm_b[kTile];
  __shared__ float warp_partial[kThreads / 32][2];
  __shared__ bool last_block;

  float acc[kRowsPerThread];
  gram_tile(a, b, row0, col0, batch, dim, ta, tb, norm_a, norm_b, acc);

  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const float k_lower = expf(-lower * inv2s2);
  const float k_upper = expf(-upper * inv2s2);
  float plain = 0.f;
  float bounded = 0.f;
  const int col = col0 + tx;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kRowStep;
    const int row = row0 + r;
    if (row < batch && col < batch && (symmetric ? row < col : row != col)) {
      const float dist = fmaxf(norm_a[r] - 2.f * acc[i] + norm_b[tx], 0.f);
      const float k = expf(-dist * inv2s2);
      plain += k;
      if (pair == 0) bounded += dist < lower ? k_lower : k;
      if (pair == 2) bounded += dist > upper ? k_upper : k;
    }
  }
  plain = warp_sum(plain);
  bounded = warp_sum(bounded);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_partial[warp][0] = plain;
    warp_partial[warp][1] = bounded;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = 0.f, q = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      p += warp_partial[w][0];
      q += warp_partial[w][1];
    }
    partials[2 * block] = p;
    partials[2 * block + 1] = symmetric ? q : p;   // e_kxy_b = e_kxy
    // release: this block's partials are visible before its ticket counts;
    // acquire: the last block sees every block's partials
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(g_forward_ticket);
    last_block = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;

  // The last block: warp w produces out[w] from the plain (w < 3) or
  // bounded (w >= 3) sums of matrix w % 3, in block order. The sums of the
  // symmetric matrices cover i < j only and are doubled.
  if (warp < kOutputs) {
    const int p = warp % 3;
    const int slot = warp / 3;
    const int first = p == 0 ? 0 : p == 1 ? n_sym : n_sym + tiles * tiles;
    const int count = p == 1 ? tiles * tiles : n_sym;
    float s = 0.f;
    for (int t = lane; t < count; t += 32) s += __ldcg(&partials[2 * (first + t) + slot]);
    s = warp_sum(s);
    const float denom = static_cast<float>(batch) * static_cast<float>(batch - 1);
    if (lane == 0) out[warp] = (p == 1 ? s : 2.f * s) / denom;
  }
  if (threadIdx.x == 0) g_forward_ticket = 0;
}

// Backward. The TPU has no counterpart: JAX's backward of fused_kernel_means
// is plain JAX (pallas_mmd.py::_fkm_bwd), which XLA fuses into the step.
// With N = B(B-1), c = ct, the raw distance R = |a_i|^2 - 2 a_i.b_j + |b_j|^2,
// D = max(R, 0), k = exp(-D * inv2s2) and every coefficient zero on i = j
// and where R < 0 (the clamp at 0):
//   alpha_ij = -(c0 + c3 [D^gg_ij >= lb]) k^gg_ij inv2s2 / N
//   beta_ij  = -(c1 + c4) k^gx_ij inv2s2 / N
//   gamma_ij = -(c2 + c5 [D^xx_ij <= ub]) k^xx_ij inv2s2 / N
//   g_gen_i = sum_j 4 alpha_ij (a_i - a_j) + sum_j 2 beta_ij (a_i - b_j)
//   g_x_j   = sum_i 2 beta_ij (b_j - a_i) + sum_k 4 gamma_jk (b_j - b_k)
// (>= and <= follow the forward's select and torch.clamp's gradient).
//
// What bounds it on an H100: the function needs each Gram entry once (the
// forward's B(B-1)/2 + B^2 + B(B-1)/2 entries), 2d flops for it and 4d to
// add it into both endpoint rows; at B=64, d=16 about 0.8 MFLOP (12 ns of
// the fp32 pipe), at (256, 256) 0.2 GFLOP (3 us). The design it replaces
// gave each block 32 output rows and walked every column tile, recomputing
// each Gram entry once per 32 output features and each symmetric entry at
// both of its rows: 16 blocks on 132 SMs at B=256, 8 Gram passes per entry
// at d=256, idle threads wherever d < 32; it lost to the plain closed form
// at d=256 (1.6 ms at (256, 256)).
//
// This one takes the forward's pieces (the upper tiles of gen-gen and
// data-data, every tile of gen-data: 10 at B=64, 136 at B=256), each a
// thread-block cluster of `ranks` blocks that split d into 32-feature
// chunks: as many ranks as the chunks allow (at most 8, the portable
// cluster size) while the whole grid fits on the card at once, so 8 at
// (64, 256) and 1 wherever d <= 32 or the pieces already fill the card. A
// rank streams its chunks of the row and column strips through a ring of
// kStages chunks in shared memory with cp.async and sums its part of the
// tile's Gram entries; the ranks add their parts through distributed
// shared memory in rank order, so each entry is computed once over the
// whole d and every rank holds the same tile. Each then forms D, k and the
// coefficient of each entry, kept as a 32 x 32 tile (and its transpose) in
// shared memory, and accumulates w_rc (own_r - partner_c) for the tile's
// rows and, off the diagonal, w_rc (partner_c - own_r) for its columns, over
// its own chunks walked back (the last kStages are still staged): every
// output feature from the same coefficients, threads mapped onto (row,
// feature) across the chunk, so all 256 work down to d = 4. Each sum is a
// partial strip of 32 x d floats in the wrapper's scratch, at a slot fixed
// by the piece. A release-acquire ticket per (side, row tile, rank) counts
// the 2t strips of that tile; the block that draws the last adds its
// rank's columns of them in slot order, writes those rows and resets the
// counter, so the gradient is bitwise the same from launch to launch and a
// CUDA graph replays it. No atomics on floats. The counters admit one
// launch per device at a time, as the forward's does, and t <= kMaxTiles
// (the wrapper raises above). The raw distance is (|own|^2 + |partner|^2)
// - 2 G, the norms by one code and G summed in one order, so on a diagonal
// tile G_ij == G_ji and the two ends of a pair see the same mask; off the
// diagonal an entry is computed once for both rows. fp32 FMAs only: TF32
// would move raw distances across the 0, lb and ub masks, and the fp32 pipe
// is not what sets the pace (at (256, 256) the strips' reduction through
// L2 and the accumulation's shared-memory loads are; at d = 16 the launch,
// the chunk's copy and the ticket's round trips).

constexpr int kLd = kChunk + 4;   // row stride of the backward's tiles: float4 rows, no conflicts
constexpr int kStages = 4;        // chunks of both strips in flight through shared memory
constexpr int kMaxTiles = 128;    // row tiles per side the tickets count: B <= 4096
constexpr int kMaxRanks = 8;      // blocks of a piece, one cluster: the portable cluster size

// One counter per (side, row tile, rank), reset by the block that finishes it.
__device__ unsigned int g_backward_ticket[2 * kMaxTiles * kMaxRanks];

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Starts copying features k0 .. k0 + 32 of rows row0 .. row0 + 32 of `src`
// into dst: rows at or past `batch` and features at or past `dim` (up to the
// next multiple of 4) read as zero. `vec`: dim % 4 == 0 and every pointer
// 16-byte aligned, so each thread copies 16 bytes at a time.
__device__ __forceinline__ void stage_strip(float (*dst)[kLd], const float* __restrict__ src,
                                            int row0, int k0, int batch, int dim, bool vec) {
  const int kw = min(kChunk, (dim - k0 + 3) & ~3);
  const int step = vec ? 4 : 1;
  const int per_row = kw / step;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row;
    const int k = (e % per_row) * step;
    const bool valid = row0 + r < batch && k0 + k < dim;
    const float* s = valid ? src + (size_t)(row0 + r) * dim + k0 + k : src;
    if (vec) {
      cp_async16(&dst[r][k], s, valid);
    } else {
      cp_async4(&dst[r][k], s, valid);
    }
  }
}

// acc[i] = sum_x m[q_i][x] (self[q_i][f] - other[x][f]) over the tile's 32
// partners x, for the rows q_i = q0 + i * step, in x order.
template <int R>
__device__ __forceinline__ void rows_sum(float (*self)[kLd], float (*other)[kLd],
                                         float (*m)[kLd], int q0, int step, int f,
                                         float acc[R]) {
  float own[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    own[i] = self[q0 + i * step][f];
    acc[i] = 0.f;
  }
#pragma unroll
  for (int x = 0; x < kTile; x += 4) {
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = other[x + u][f];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 w = *reinterpret_cast<const float4*>(&m[q0 + i * step][x]);
      acc[i] = fmaf(w.x, own[i] - o[0], acc[i]);
      acc[i] = fmaf(w.y, own[i] - o[1], acc[i]);
      acc[i] = fmaf(w.z, own[i] - o[2], acc[i]);
      acc[i] = fmaf(w.w, own[i] - o[3], acc[i]);
    }
  }
}

// One staged chunk of kn features, f0.. of d, into the partial strips:
// out_r[q][f0 + f] for the tile's rows and, when `cols`, out_c for its
// columns. FP lanes per row (kn rounded up to a power of two) and the
// 256 / FP row groups of the block cover the 64 (row, side) pairs: FP >= 8,
// each thread 32 / (256 / FP) rows of both sides; FP <= 4, one row of one
// side (below d = 4 some threads idle).
template <int FP>
__device__ __forceinline__ void accumulate_chunk(float (*own)[kLd],
                                                 float (*part)[kLd],
                                                 float (*w)[kLd], float (*wt)[kLd],
                                                 bool cols, int kn, int f0, int dim,
                                                 float* __restrict__ out_r,
                                                 float* __restrict__ out_c) {
  constexpr int kGroups = kThreads / FP;
  const int f = threadIdx.x % FP;
  const int g = threadIdx.x / FP;
  if (f >= kn) return;
  if constexpr (kGroups <= kTile) {
    constexpr int R = kTile / kGroups;
    float acc[R];
    rows_sum<R>(own, part, w, g, kGroups, f, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) out_r[(size_t)(g + i * kGroups) * dim + f0 + f] = acc[i];
    if (cols) {
      rows_sum<R>(part, own, wt, g, kGroups, f, acc);
#pragma unroll
      for (int i = 0; i < R; ++i) out_c[(size_t)(g + i * kGroups) * dim + f0 + f] = acc[i];
    }
  } else {
    float acc[1];
    if (g < kTile) {
      rows_sum<1>(own, part, w, g, 0, f, acc);
      out_r[(size_t)g * dim + f0 + f] = acc[0];
    } else if (g < 2 * kTile && cols) {
      rows_sum<1>(part, own, wt, g - kTile, 0, f, acc);
      out_c[(size_t)(g - kTile) * dim + f0 + f] = acc[0];
    }
  }
}

__device__ __forceinline__ void accumulate(float (*own)[kLd], float (*part)[kLd],
                                           float (*w)[kLd], float (*wt)[kLd],
                                           bool cols, int kn, int f0, int dim, float* out_r,
                                           float* out_c) {
  if (kn > 16) {
    accumulate_chunk<32>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  } else if (kn > 8) {
    accumulate_chunk<16>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  } else if (kn > 4) {
    accumulate_chunk<8>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  } else if (kn > 2) {
    accumulate_chunk<4>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  } else if (kn > 1) {
    accumulate_chunk<2>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  } else {
    accumulate_chunk<1>(own, part, w, wt, cols, kn, f0, dim, out_r, out_c);
  }
}

// The partial strip of (side, row tile) at `slot`: [32, d] floats. Each side
// has t row tiles of 2t slots: gen rows take their gen-gen partner tiles,
// then their gen-data ones; data rows their gen-data partner tiles, then
// their data-data ones.
__device__ __forceinline__ float* strip(float* scratch, int side, int row_tile, int slot,
                                        int tiles, int dim) {
  return scratch + ((size_t)(side * tiles + row_tile) * 2 * tiles + slot) * kTile * dim;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// out[q][f] = strips[q][f] + strips[stride + q][f] + ... over `count`
// strips, added in that order, for the rows q < rows and the columns f <
// width of a slice whose rows are `ld` apart: a thread loads up to kBatch
// strips' values of its element at once, so that they are in flight from
// L2 together.
template <typename T>
__device__ __forceinline__ void add_strips(const T* strips, T* out, int rows, int width, int ld,
                                           size_t stride, int count) {
  constexpr int kBatch = 16;
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int at = e / width * ld + e % width;
    T sum = __ldcg(&strips[at]);
    for (int p0 = 1; p0 < count; p0 += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p0 + u < count) v[u] = __ldcg(&strips[(p0 + u) * stride + at]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p0 + u < count) sum = add(sum, v[u]);
    }
    out[at] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
kernel_means_bwd(const float* __restrict__ sg, const float* __restrict__ sx,
                 const float* __restrict__ ct, float* scratch,
                 float* __restrict__ g_gen, float* __restrict__ g_x, int batch, int dim,
                 float inv2s2, float lower, float upper, int ranks, bool vec) {
  const int tiles = num_tiles(batch);
  const int n_sym = tiles * (tiles + 1) / 2;
  const int block = blockIdx.x / ranks;    // the piece; `ranks` blocks, one cluster
  const int rank = blockIdx.x % ranks;
  int pair, tile_r, tile_c;
  if (block < n_sym) {
    pair = 0;
    upper_tile(block, tiles, &tile_r, &tile_c);
  } else if (block < n_sym + tiles * tiles) {
    pair = 1;
    tile_r = (block - n_sym) / tiles;
    tile_c = (block - n_sym) % tiles;
  } else {
    pair = 2;
    upper_tile(block - n_sym - tiles * tiles, tiles, &tile_r, &tile_c);
  }
  const float* __restrict__ a = pair == 2 ? sx : sg;   // rows
  const float* __restrict__ b = pair == 0 ? sg : sx;   // columns
  const int row0 = tile_r * kTile;
  const int col0 = tile_c * kTile;
  const bool cols = pair == 1 || tile_r != tile_c;     // a diagonal tile holds both ends
  // (side, row tile, slot) of the row strip and of the column strip
  const int side_r = pair == 2 ? 1 : 0;
  const int side_c = pair == 0 ? 0 : 1;
  const int slot_r = pair == 0 ? tile_c : tiles + tile_c;
  const int slot_c = pair == 2 ? tiles + tile_r : tile_r;
  float* out_r = strip(scratch, side_r, tile_r, slot_r, tiles, dim);
  float* out_c = strip(scratch, side_c, tile_c, slot_c, tiles, dim);

  __shared__ __align__(16) float ta[kStages][kTile][kLd];   // row strip, a ring of chunks
  __shared__ __align__(16) float tb[kStages][kTile][kLd];   // column strip, likewise
  __shared__ __align__(16) float w[kTile][kLd];       // the tile's coefficients
  __shared__ __align__(16) float wt[kTile][kLd];      // and their transpose
  __shared__ float norm_a[kTile];
  __shared__ float norm_b[kTile];
  __shared__ int finish[2];

  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  // this rank's chunks of 32 features, first .. last - 1
  const int chunks = (dim + kChunk - 1) / kChunk;
  const int first = rank * ((chunks + ranks - 1) / ranks);
  const int last = min(chunks, first + (chunks + ranks - 1) / ranks);

  // chunk c of both strips into stage c % kStages; one commit group per call
  auto stage = [&](int c) {
    if (c >= first && c < last) {
      stage_strip(ta[c % kStages], a, row0, c * kChunk, batch, dim, vec);
      stage_strip(tb[c % kStages], b, col0, c * kChunk, batch, dim, vec);
    }
    cp_async_commit();
  };

  // Gram entries of the tile over this rank's features, with kStages - 1
  // chunks in flight; thread (ty, tx) holds rows ty + 8i, column tx.
  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  float norm = 0.f;   // threads 0..31: |a_row|^2, threads 32..63: |b_col|^2
  for (int c = first; c < first + kStages - 1; ++c) stage(c);
  for (int c = first; c < last; ++c) {
    stage(c + kStages - 1);   // into the stage chunk c - 1 left
    cp_async_wait<kStages - 1>();   // chunk c has landed
    __syncthreads();
    const int s = c % kStages;
    const int kn4 = min(kChunk, (dim - c * kChunk + 3) & ~3);   // zeros past d add nothing
    if (threadIdx.x < 2 * kTile) {
      float(*t)[kLd] = threadIdx.x < kTile ? ta[s] : tb[s];
      for (int k = 0; k < kn4; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&t[tx][k]);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    for (int k = 0; k < kn4; k += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(&tb[s][tx][k]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(&ta[s][ty + i * kRowStep][k]);
        acc[i] = fmaf(av.x, bv.x, acc[i]);
        acc[i] = fmaf(av.y, bv.y, acc[i]);
        acc[i] = fmaf(av.z, bv.z, acc[i]);
        acc[i] = fmaf(av.w, bv.w, acc[i]);
      }
    }
    __syncthreads();   // stage s is copied into again for chunk c + kStages
  }
  if (ranks > 1) {
    // the cluster's partial sums over the whole d, added in rank order by
    // every rank alike: each rank's w and norms hold its own until all read
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) w[ty + i * kRowStep][tx] = acc[i];
    if (threadIdx.x < 2 * kTile) (threadIdx.x < kTile ? norm_a : norm_b)[tx] = norm;
    cluster.sync();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      acc[i] = cluster.map_shared_rank(&w[0][0], 0)[(ty + i * kRowStep) * kLd + tx];
      for (int r = 1; r < ranks; ++r)
        acc[i] += cluster.map_shared_rank(&w[0][0], r)[(ty + i * kRowStep) * kLd + tx];
    }
    if (threadIdx.x < 2 * kTile) {
      float* own = threadIdx.x < kTile ? norm_a : norm_b;
      norm = cluster.map_shared_rank(own, 0)[tx];
      for (int r = 1; r < ranks; ++r) norm += cluster.map_shared_rank(own, r)[tx];
    }
    cluster.sync();
  }
  if (threadIdx.x < kTile) {
    norm_a[tx] = norm;
  } else if (threadIdx.x < 2 * kTile) {
    norm_b[tx] = norm;
  }
  __syncthreads();

  // D, k and the coefficient of each entry, once
  const float scale = -inv2s2 / (static_cast<float>(batch) * static_cast<float>(batch - 1));
  const float c_plain = pair == 1 ? 2.f * (ct[1] + ct[4]) * scale
                                  : 4.f * (pair == 0 ? ct[0] : ct[2]) * scale;
  const float c_bound = pair == 1 ? 0.f : 4.f * (pair == 0 ? ct[3] : ct[5]) * scale;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kRowStep;
    const int row = row0 + r;
    const int col = col0 + tx;
    const float raw = fmaf(-2.f, acc[i], norm_a[r] + norm_b[tx]);
    float coef = 0.f;
    if (row < batch && col < batch && row != col && raw >= 0.f) {
      const bool bounded = pair == 0 ? raw >= lower : pair == 2 && raw <= upper;
      coef = (c_plain + (bounded ? c_bound : 0.f)) * expf(-raw * inv2s2);
    }
    w[r][tx] = coef;
    wt[tx][r] = coef;
  }
  __syncthreads();

  // every output feature from those coefficients, the chunks walked back:
  // the last kStages are still staged; once chunk c is summed, its stage
  // takes chunk c - kStages, kStages - 1 chunks ahead of its turn
  for (int c = last - 1; c >= first; --c) {
    cp_async_wait<kStages - 1>();   // chunk c has landed
    __syncthreads();
    accumulate(ta[c % kStages], tb[c % kStages], w, wt, cols, min(kChunk, dim - c * kChunk),
               c * kChunk, dim, out_r, out_c);
    __syncthreads();
    stage(c - kStages);
  }

  // release: this block's strips are visible before its tickets count;
  // acquire: the block that draws a tile's last ticket sees all its strips
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int counters[2] = {(side_r * tiles + tile_r) * ranks + rank,
                             cols ? (side_c * tiles + tile_c) * ranks + rank : -1};
    for (int j = 0; j < 2; ++j) {
      finish[j] = -1;
      if (counters[j] < 0) continue;
      cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
          g_backward_ticket[counters[j]]);
      if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) == 2u * tiles - 1u) {
        finish[j] = counters[j];
        ticket.store(0u, cuda::memory_order_relaxed);
      }
    }
  }
  __syncthreads();

  // the last block of a (side, row tile, rank) adds the 2t strips' columns
  // of this rank in slot order
  const int f0 = first * kChunk;
  const int width = min(dim, last * kChunk) - f0;
  for (int j = 0; j < 2; ++j) {
    if (finish[j] < 0) continue;
    const int side = finish[j] / ranks / tiles;
    const int row_tile = finish[j] / ranks % tiles;
    const float* strips = strip(scratch, side, row_tile, 0, tiles, dim) + f0;
    float* grad = (side == 0 ? g_gen : g_x) + (size_t)row_tile * kTile * dim + f0;
    const int rows = min(kTile, batch - row_tile * kTile);
    if (vec) {   // every row and column offset a multiple of 4 floats
      add_strips(reinterpret_cast<const float4*>(strips), reinterpret_cast<float4*>(grad), rows,
                 width / 4, dim / 4, (size_t)kTile * dim / 4, 2 * tiles);
    } else {
      add_strips(strips, grad, rows, width, dim, (size_t)kTile * dim, 2 * tiles);
    }
  }
}

// Ranks of a piece at d on `device`: as many as the chunks of d allow, up to
// kMaxRanks, while pieces x ranks blocks still fit on the card at once (its
// SMs times the kernel's resident blocks on one, read once per device);
// every rank takes at least one chunk. At least one.
int backward_ranks(int pieces, int dim, int device) {
  constexpr int kMaxDevices = 64;
  static int slots[kMaxDevices] = {};
  int fit = 0;
  if (device >= 0 && device < kMaxDevices && slots[device] > 0) {
    fit = slots[device];
  } else {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_means_bwd, kThreads, 0) ==
            cudaSuccess) {
      fit = sms * per_sm;
      if (device >= 0 && device < kMaxDevices) slots[device] = fit;
    }
  }
  const int chunks = (dim + kChunk - 1) / kChunk;
  const int cap = std::max(1, std::min({kMaxRanks, chunks, fit / pieces}));
  const int per_rank = (chunks + cap - 1) / cap;
  return (chunks + per_rank - 1) / per_rank;
}

// The library links its own CUDA runtime; its current device is set to the
// tensors' device only where it differs, since the call is on the host's
// critical path once per step.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One launch on `stream` of device `device`: writes out[6], the first six
// floats of `buf`, and keeps the blocks' partial sums in the
// 2 * forward_blocks(t) floats after them (the wrapper sizes `buf`).
// Returns the CUDA error code as an int, 0 on success.
int mmd_kernel_means(const void* sg, const void* sx, void* buf, int batch, int dim,
                     float inv2s2, float lower, float upper, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* out = static_cast<float*>(buf);
  kernel_means_fwd<<<forward_blocks(num_tiles(batch)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sg), static_cast<const float*>(sx), out + kOutputs, out,
      batch, dim, inv2s2, lower, upper);
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream` of device `device`: g_gen and g_x [B, d] from the
// scores and the cotangent ct[6], all in device memory; `scratch` holds the
// 4 t^2 partial strips of 32 x d floats (t = ceil(B / 32), at most
// kMaxTiles; the wrapper sizes it). Returns the CUDA error code as an int,
// 0 on success.
int mmd_kernel_means_backward(const void* sg, const void* sx, const void* ct, void* scratch,
                              void* g_gen, void* g_x, int batch, int dim, float inv2s2,
                              float lower, float upper, int device, void* stream) {
  const int tiles = num_tiles(batch);
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* pointers[] = {sg, sx, scratch, g_gen, g_x};
  bool vec = dim % 4 == 0;
  for (const void* ptr : pointers) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  // a cluster of `ranks` blocks per piece of the forward's schedule
  const int ranks = backward_ranks(forward_blocks(tiles), dim, device);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(forward_blocks(tiles) * ranks);
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = ranks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel_means_bwd, static_cast<const float*>(sg),
                           static_cast<const float*>(sx), static_cast<const float*>(ct),
                           static_cast<float*>(scratch), static_cast<float*>(g_gen),
                           static_cast<float*>(g_x), batch, dim, inv2s2, lower, upper, ranks,
                           vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* mmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
