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
// Both kernels share the tile code: a 256-thread block takes a 32 x 32
// tile of one of the three matrices, stages its row and column scores in
// shared memory in chunks of 32 features (any B >= 2 and d >= 1 fit) and
// forms the dot products with plain fp32 FMAs. No TF32 and no tensor
// cores: the reference computes these Gram matrices at full fp32
// precision, and at these sizes the work is nanoseconds on any pipe.
//
// What bounds both on an H100: at the main path's B=64, d=16 the forward
// reads 8,192 bytes and needs 8,128 Gram entries of depth 16 (B(B-1)/2 of
// each symmetric matrix, B^2 of gen-data), about 0.3 MFLOP and one
// exponential per entry; the backward the same entries again plus 4d
// flops each to accumulate both endpoint rows. That is a few nanoseconds
// of memory, fp32 or special-function time, while one launch takes
// microseconds: launches and the host's cost per call set their time, so
// each direction is one launch with no host synchronisation, no
// allocation and no atomics on floats.

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
// One launch of 2t blocks (4 at B=64): block (side, tile) owns 32 rows of
// g_gen (side 0) or g_x (side 1). It walks every column tile of both
// partner matrices, recomputes D and k in registers rather than reading a
// stored matrix, stages the tile's coefficients in shared memory and adds
// w_rc (own_r - partner_c) into its rows, 32 output features at a time.
// Every output element is summed by one thread in a fixed order and
// written once: no atomics, bitwise the same from run to run. The raw
// distance is formed as (|own|^2 + |partner|^2) - 2 G, symmetric in its
// two rows, so the two blocks that own the ends of a gen-gen or data-data
// pair see the same D. The cost of the row-owner design is that each
// symmetric entry is recomputed by both of its rows' owners; it is still
// launch-bound.
__global__ void __launch_bounds__(kThreads)
kernel_means_bwd(const float* __restrict__ sg, const float* __restrict__ sx,
                 const float* __restrict__ ct, float* __restrict__ g_gen,
                 float* __restrict__ g_x, int batch, int dim, float inv2s2,
                 float lower, float upper) {
  const int tiles = num_tiles(batch);
  const int side = blockIdx.x / tiles;          // 0: gen rows, 1: data rows
  const int row0 = (blockIdx.x % tiles) * kTile;
  const float* __restrict__ own = side == 0 ? sg : sx;
  float* __restrict__ grad = side == 0 ? g_gen : g_x;

  __shared__ float ta[kTile][kChunk + 1];
  __shared__ float tb[kTile][kChunk + 1];
  __shared__ float norm_a[kTile];
  __shared__ float norm_b[kTile];
  __shared__ float w[kTile][kTile + 1];          // the tile's coefficients
  __shared__ float own_f[kTile][kChunk + 1];     // own rows, output features
  __shared__ float part_f[kTile][kChunk + 1];    // partner rows, output features

  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  const float scale = -inv2s2 / (static_cast<float>(batch) * static_cast<float>(batch - 1));
  const float c_cross = 2.f * (ct[1] + ct[4]) * scale;

  for (int f0 = 0; f0 < dim; f0 += kChunk) {
    const int fn = min(kChunk, dim - f0);
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int f = e % kChunk;
      own_f[r][f] = (row0 + r < batch && f0 + f < dim)
                        ? own[(size_t)(row0 + r) * dim + f0 + f] : 0.f;
    }
    float g[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};

    // partner 0 is the same side (factor 4), partner 1 the other (factor 2)
    for (int partner = 0; partner < 2; ++partner) {
      const bool same = partner == 0;
      const float* __restrict__ pm = (side == 0) == same ? sg : sx;
      // coefficient of a same-side entry: plain and bounded parts
      const float c_plain = 4.f * (side == 0 ? ct[0] : ct[2]) * scale;
      const float c_bound = 4.f * (side == 0 ? ct[3] : ct[5]) * scale;
      for (int col0 = 0; col0 < batch; col0 += kTile) {
        float acc[kRowsPerThread];
        gram_tile(own, pm, row0, col0, batch, dim, ta, tb, norm_a, norm_b, acc);
        const int col = col0 + tx;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = ty + i * kRowStep;
          const int row = row0 + r;
          float coef = 0.f;
          const float raw = fmaf(-2.f, acc[i], norm_a[r] + norm_b[tx]);
          if (row < batch && col < batch && row != col && raw >= 0.f) {
            const float k = expf(-raw * inv2s2);
            if (!same) {
              coef = c_cross * k;
            } else if (side == 0) {
              coef = (c_plain + (raw >= lower ? c_bound : 0.f)) * k;
            } else {
              coef = (c_plain + (raw <= upper ? c_bound : 0.f)) * k;
            }
          }
          w[r][tx] = coef;
        }
        for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
          const int r = e / kChunk;
          const int f = e % kChunk;
          part_f[r][f] = (col0 + r < batch && f0 + f < dim)
                             ? pm[(size_t)(col0 + r) * dim + f0 + f] : 0.f;
        }
        __syncthreads();
        // thread (ty, tx) accumulates feature f0 + tx of rows ty + 8i
        if (tx < fn) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int r = ty + i * kRowStep;
            const float a_rf = own_f[r][tx];
            for (int c = 0; c < kTile; ++c)
              g[i] = fmaf(w[r][c], a_rf - part_f[c][tx], g[i]);
          }
        }
        __syncthreads();   // w and part_f are rewritten by the next tile
      }
    }
    if (tx < fn) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = row0 + ty + i * kRowStep;
        if (row < batch) grad[(size_t)row * dim + f0 + tx] = g[i];
      }
    }
  }
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
// scores and the cotangent ct[6], all in device memory. Returns the CUDA
// error code as an int, 0 on success.
int mmd_kernel_means_backward(const void* sg, const void* sx, const void* ct, void* g_gen,
                              void* g_x, int batch, int dim, float inv2s2, float lower,
                              float upper, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_means_bwd<<<2 * num_tiles(batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sg), static_cast<const float*>(sx),
      static_cast<const float*>(ct), static_cast<float*>(g_gen), static_cast<float*>(g_x),
      batch, dim, inv2s2, lower, upper);
  return static_cast<int>(cudaGetLastError());
}

const char* mmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
