// Six off-diagonal Gaussian-kernel means of two score matrices, for the
// repulsive MMD losses 'rep' and 'rmb'.
//
// Replaces mmdgan_tpu/ops/pallas_mmd.py::_kernel_means_kernel (the Pallas
// TPU kernel launched by _kernel_means). Given generated scores sg and real
// scores sx, both fp32 [B, d] row-major, it writes
//   out[6] = (e_kxx, e_kxy, e_kyy, e_kxx_b, e_kxy_b, e_kyy_b)
// where xx = gen-gen, xy = gen-data, yy = data-data,
//   D_ij     = max(|a_i|^2 - 2 a_i.b_j + |b_j|^2, 0)
//   k        = exp(-D * inv2s2)
//   k_xx_b   = exp(-max(D_xx, lb) * inv2s2)   (gen-gen, lower-bounded)
//   k_yy_b   = exp(-min(D_yy, ub) * inv2s2)   (data-data, upper-bounded)
//   k_xy_b   = k_xy                           (repulsive direction)
// and every mean is the sum over i != j divided by B(B-1).
//
// What bounds it on an H100: at the main path's B=64, d=16 it reads
// 2*64*16*4 = 8,192 bytes and writes 24 bytes. The gen-gen and data-data
// matrices are symmetric, so the function needs B(B-1)/2 entries of each
// and B^2 of gen-data: 8,128 Gram entries of depth 16, about 0.3 MFLOP of
// fp32 and one exponential per entry (the bounded kernels are a select
// against the constant exp(-bound * inv2s2), not a second exponential).
// That is a few nanoseconds of memory, fp32 or special-function time, so
// the launch latency sets its time, not the arithmetic.
//
// What the design does about that: the whole function is two launches of
// small grids with no host synchronisation and no allocation, issued on
// the caller's stream. Pass 1 tiles the B x B grid of each of the three
// matrices into 32 x 32 tiles, one block per (tile, matrix); blocks below
// the diagonal of the two symmetric matrices write zero and return, and
// their diagonal tiles keep only row < col. A block stages its row and
// column score tiles in shared memory in chunks of 32 features, so any
// B >= 2 and d >= 1 fit, and forms the dot products with plain fp32 FMAs
// (no TF32, no tensor cores: the reference computes these Gram matrices
// at full fp32 precision). It masks the diagonal and the ragged edge,
// reduces in-block in a fixed order and writes two partial sums. Pass 2,
// one block, adds the partials in a fixed order and doubles the symmetric
// sums: no float atomics, so a result is the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // rows and columns of a block's tile
constexpr int kChunk = 32;                // features staged per pass
constexpr int kThreads = 256;             // 8 warps
constexpr int kRowStep = kThreads / kTile;            // 8
constexpr int kRowsPerThread = kTile / kRowStep;      // 4
constexpr int kOutputs = 6;

int num_tiles(int batch) { return (batch + kTile - 1) / kTile; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// grid (tiles, tiles, 3): blockIdx.z picks the matrix
// (0: gen-gen, 1: gen-data, 2: data-data); partials[block][2] receives
// the tile's sums of the plain and the bounded kernel.
__global__ void __launch_bounds__(kThreads)
tile_sums(const float* __restrict__ sg, const float* __restrict__ sx,
          float* __restrict__ partials, int batch, int dim,
          float inv2s2, float lower, float upper) {
  const int pair = blockIdx.z;
  const float* __restrict__ a = pair == 2 ? sx : sg;   // rows
  const float* __restrict__ b = pair == 0 ? sg : sx;   // columns
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int block = (pair * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const bool symmetric = pair != 1;
  if (symmetric && blockIdx.y > blockIdx.x) {   // the mirror tile counts it
    if (threadIdx.x == 0) partials[2 * block] = partials[2 * block + 1] = 0.f;
    return;
  }

  __shared__ float ta[kTile][kChunk + 1];   // +1: conflict-free column reads
  __shared__ float tb[kTile][kChunk + 1];
  __shared__ float norm_a[kTile];
  __shared__ float norm_b[kTile];
  __shared__ float warp_partial[kThreads / 32][2];

  const int tx = threadIdx.x % kTile;   // column of the tile
  const int ty = threadIdx.x / kTile;   // rows ty, ty + 8, ty + 16, ty + 24
  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
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

  // exp(-max(D, lower)) and exp(-min(D, upper)) equal exp(-D) unless the
  // bound holds, and then the constant exp(-bound)
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
  if (threadIdx.x % 32 == 0) {
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
  }
}

// One block of six warps; warp w produces out[w]. Output w reads the
// plain (w < 3) or bounded (w >= 3) sums of matrix w % 3; e_kxy_b is the
// gen-data matrix's bounded sum, which equals its plain sum. The sums of
// the symmetric matrices cover i < j only and are doubled.
__global__ void finish(const float* __restrict__ partials, float* __restrict__ out,
                       int tiles_per_pair, float denom) {
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = w % 3;
  const int slot = w / 3;
  float s = 0.f;
  for (int t = lane; t < tiles_per_pair; t += 32)
    s += partials[2 * (pair * tiles_per_pair + t) + slot];
  s = warp_sum(s);
  if (lane == 0) out[w] = (pair == 1 ? s : 2.f * s) / denom;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for a batch of `batch` rows.
int mmd_scratch_floats(int batch) {
  const int t = num_tiles(batch);
  return 2 * 3 * t * t;
}

// Launches both passes on `stream` of device `device`; returns the CUDA
// error code as an int (0 on success). The library links its own CUDA
// runtime, whose current device is set here to the tensors' device.
int mmd_kernel_means(const void* sg, const void* sx, void* partials, void* out,
                     int batch, int dim, float inv2s2, float lower, float upper,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = num_tiles(batch);
  tile_sums<<<dim3(t, t, 3), kThreads, 0, s>>>(
      static_cast<const float*>(sg), static_cast<const float*>(sx),
      static_cast<float*>(partials), batch, dim, inv2s2, lower, upper);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish<<<1, 32 * kOutputs, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), t * t,
      static_cast<float>(batch) * static_cast<float>(batch - 1));
  return static_cast<int>(cudaGetLastError());
}

const char* mmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
