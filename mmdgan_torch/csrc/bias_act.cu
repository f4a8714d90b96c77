// A conv block's bias, return to the 16-bit compute dtype and activation,
// forward and backward, in one pass each way over a map held channels_last.
//
// It replaces no TPU kernel: XLA fuses this epilogue into the convolution
// on the TPU. On the H100 the port ran it as PyTorch's separate
// elementwise kernels: x + bias promoted the map to float32, a cast took
// it back to bf16 or fp16, the activation read and wrote it again, and the
// backward made as many passes (activation gradient, copy to float32, the
// bias's GEMV, cast back). Those passes bound the training step at large
// maps: 56 bytes moved per element and direction pair, where this pair
// moves 16.
//
// The map is seen as its NHWC memory: `rows` = N*H*W rows of `channels`
// values, bf16 or fp16. Forward, per element, in float:
//   t = round(float(x) + bias[c])           (x + bias in float32, cast back)
//   y = round(act(float(t)))                (the 16-bit activation)
// with act one of linear, relu, lrelu (slope 0.1) and tanh, each written as
// PyTorch's CUDA kernels compute it, so that y is bitwise theirs.
// Backward, from the output gradient g and the saved output y:
//   gx = round(g * act'(y))                 (the activation's gradient)
//   gb[c] = sum over rows of float(gx)      (the bias's, where it needs one)
// y stands in for the activation's input: relu and lrelu keep its sign
// (y > 0 exactly where t > 0) and tanh's gradient needs only y.
//
// What bounds it on an H100: memory. A forward reads 2 and writes 2 bytes
// per element, a backward reads 4 and writes 2; a few flops per element
// are far below the card's 295 flops per byte. So each thread moves 16
// bytes per load and store (8 channels, where the channels divide by 8 and
// the pointers are aligned; else one element), keeps kUnroll rows in
// flight, and owns a fixed group of channels for its whole life: its 8
// biases stay in registers, and in the backward its 8 float32 partial sums
// of the bias's gradient too. A block owns `width` channel groups of
// `kThreads / width` rows per pass; blocks stride over the rows. The
// bias's gradient is summed in a fixed order (each thread over its rows,
// the block over its threads' rows in shared memory, then
// bias_grad_finish over the blocks), so reruns are bitwise equal; no
// atomics. Every launch goes on the caller's stream and allocates nothing,
// so it captures into a CUDA graph.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // rows in flight per thread
constexpr int kFinishLanes = kThreads / 32;
constexpr float kLreluSlope = 0.1f;        // F.leaky_relu's 0.1 in float

enum Act : int { kLinear = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };
enum Dtype : int { kBf16 = 0, kFp16 = 1 };

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half round_to<__half>(float v) {
  return __float2half_rn(v);
}

// kVec values of one row, loaded and stored as one access (16 bytes at 8).
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

// The _rn intrinsics keep nvcc from contracting a product and a sum into
// one FMA, which PyTorch's kernels do not do either.
template <typename T, int kAct>
__device__ __forceinline__ T forward_one(T x, float bias) {
  const T t = round_to<T>(__fadd_rn(to_float(x), bias));
  if (kAct == kLinear) return t;
  const float f = to_float(t);
  if (kAct == kRelu) return f != f ? t : round_to<T>(fmaxf(f, 0.0f));   // clamp_min(t, 0)
  if (kAct == kLrelu) return f > 0.0f ? t : round_to<T>(__fmul_rn(f, kLreluSlope));
  return round_to<T>(tanhf(f));
}

template <typename T, int kAct>
__device__ __forceinline__ T backward_one(T g, T y) {
  if (kAct == kLinear) return g;
  const float fy = to_float(y);
  if (kAct == kRelu) return fy <= 0.0f ? round_to<T>(0.0f) : g;   // threshold_backward
  if (kAct == kLrelu) return fy > 0.0f ? g : round_to<T>(__fmul_rn(to_float(g), kLreluSlope));
  // tanh_backward in the 16-bit type: g * (1 - y * y), each step rounded
  const T yy = round_to<T>(__fmul_rn(fy, fy));
  const T d = round_to<T>(__fsub_rn(1.0f, to_float(yy)));
  return round_to<T>(__fmul_rn(to_float(g), to_float(d)));
}

// Where a thread works: channel group `lane` of the block's slab, row
// `row` of each pass; `active` is false for the threads past the last
// full pass of rows and for groups past the last channel.
struct Place {
  int lane, row, rows_per_pass, c0;
  bool active;
};

template <int kVec>
__device__ __forceinline__ Place place(int channels, int width) {
  Place p;
  p.lane = threadIdx.x % width;
  p.row = threadIdx.x / width;
  p.rows_per_pass = kThreads / width;
  p.c0 = (blockIdx.y * width + p.lane) * kVec;
  p.active = p.row < p.rows_per_pass && p.c0 < channels;
  return p;
}

template <typename T, int kVec, int kAct>
__global__ void __launch_bounds__(kThreads)
bias_act_fwd(const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ y,
             int64_t rows, int channels, int width) {
  using P = Pack<T, kVec>;
  const Place p = place<kVec>(channels, width);
  if (!p.active) return;
  float b[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) b[j] = bias[p.c0 + j];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * p.rows_per_pass;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * p.rows_per_pass + p.row; r < rows;
       r += kUnroll * stride) {
    P in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + u * stride;
      if (ru < rows) in[u] = *reinterpret_cast<const P*>(x + ru * channels + p.c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + u * stride;
      if (ru >= rows) break;
      P out;
#pragma unroll
      for (int j = 0; j < kVec; ++j) out.v[j] = forward_one<T, kAct>(in[u].v[j], b[j]);
      *reinterpret_cast<P*>(y + ru * channels + p.c0) = out;
    }
  }
}

// gx from g and y; with kBiasGrad each block also writes its sums of gx by
// channel to partial[blockIdx.x][channels].
template <typename T, int kVec, int kAct, bool kBiasGrad>
__global__ void __launch_bounds__(kThreads)
bias_act_bwd(const T* __restrict__ g, const T* __restrict__ y, T* __restrict__ gx,
             float* __restrict__ partial, int64_t rows, int channels, int width) {
  using P = Pack<T, kVec>;
  const Place p = place<kVec>(channels, width);
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
  if (p.active) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * p.rows_per_pass;
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * p.rows_per_pass + p.row; r < rows;
         r += kUnroll * stride) {
      P gin[kUnroll], yin[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = r + u * stride;
        if (ru < rows) {
          gin[u] = *reinterpret_cast<const P*>(g + ru * channels + p.c0);
          yin[u] = *reinterpret_cast<const P*>(y + ru * channels + p.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = r + u * stride;
        if (ru >= rows) break;
        P out;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          out.v[j] = backward_one<T, kAct>(gin[u].v[j], yin[u].v[j]);
          if (kBiasGrad) acc[j] += to_float(out.v[j]);
        }
        *reinterpret_cast<P*>(gx + ru * channels + p.c0) = out;
      }
    }
  }
  if (!kBiasGrad) return;
  // The block's sums by channel: its threads' partial sums, in row order.
  __shared__ float sums[kThreads * kVec];
  const int cols = width * kVec;
  if (p.row < p.rows_per_pass) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) sums[p.row * cols + p.lane * kVec + j] = acc[j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < cols; col += kThreads) {
    const int c = blockIdx.y * cols + col;
    if (c >= channels) break;
    float s = 0.0f;
    for (int r = 0; r < p.rows_per_pass; ++r) s += sums[r * cols + col];
    partial[static_cast<int64_t>(blockIdx.x) * channels + c] = s;
  }
}

// out[c] = the sum of partial[b][c] over the `blocks` rows: kFinishLanes
// lanes of 32 channels, lane l summing the rows b = l mod kFinishLanes in
// order, then the lanes in order.
__global__ void __launch_bounds__(kThreads)
bias_grad_finish(const float* __restrict__ partial, float* __restrict__ out, int blocks,
                 int channels) {
  __shared__ float lanes[kFinishLanes][32];
  const int lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  float s = 0.0f;
  if (c < channels) {
#pragma unroll 8
    for (int b = lane; b < blocks; b += kFinishLanes)
      s += partial[static_cast<int64_t>(b) * channels + c];
  }
  lanes[lane][threadIdx.x % 32] = s;
  __syncthreads();
  if (lane == 0 && c < channels) {
    float total = 0.0f;
#pragma unroll
    for (int l = 0; l < kFinishLanes; ++l) total += lanes[l][threadIdx.x];
    out[c] = total;
  }
}

template <typename T, int kVec>
cudaError_t launch_forward(int act, dim3 grid, cudaStream_t stream, const void* x,
                           const void* bias, void* y, int64_t rows, int channels, int width) {
  const T* xt = static_cast<const T*>(x);
  const float* bt = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  switch (act) {
    case kLinear:
      bias_act_fwd<T, kVec, kLinear><<<grid, kThreads, 0, stream>>>(xt, bt, yt, rows, channels,
                                                                     width);
      break;
    case kRelu:
      bias_act_fwd<T, kVec, kRelu><<<grid, kThreads, 0, stream>>>(xt, bt, yt, rows, channels,
                                                                   width);
      break;
    case kLrelu:
      bias_act_fwd<T, kVec, kLrelu><<<grid, kThreads, 0, stream>>>(xt, bt, yt, rows, channels,
                                                                    width);
      break;
    case kTanh:
      bias_act_fwd<T, kVec, kTanh><<<grid, kThreads, 0, stream>>>(xt, bt, yt, rows, channels,
                                                                   width);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int kVec, int kAct>
cudaError_t launch_backward_act(dim3 grid, cudaStream_t stream, const T* g, const T* y, T* gx,
                                float* partial, int64_t rows, int channels, int width) {
  if (partial != nullptr)
    bias_act_bwd<T, kVec, kAct, true><<<grid, kThreads, 0, stream>>>(g, y, gx, partial, rows,
                                                                      channels, width);
  else
    bias_act_bwd<T, kVec, kAct, false><<<grid, kThreads, 0, stream>>>(g, y, gx, partial, rows,
                                                                       channels, width);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_backward(int act, dim3 grid, cudaStream_t stream, const void* g,
                            const void* y, void* gx, float* partial, int64_t rows,
                            int channels, int width) {
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* gxt = static_cast<T*>(gx);
  switch (act) {
    case kLinear:
      return launch_backward_act<T, kVec, kLinear>(grid, stream, gt, yt, gxt, partial, rows,
                                                   channels, width);
    case kRelu:
      return launch_backward_act<T, kVec, kRelu>(grid, stream, gt, yt, gxt, partial, rows,
                                                 channels, width);
    case kLrelu:
      return launch_backward_act<T, kVec, kLrelu>(grid, stream, gt, yt, gxt, partial, rows,
                                                  channels, width);
    case kTanh:
      return launch_backward_act<T, kVec, kTanh>(grid, stream, gt, yt, gxt, partial, rows,
                                                 channels, width);
    default:
      return cudaErrorInvalidValue;
  }
}

// The geometry the wrapper chose, checked against what the kernels assume.
bool valid(int64_t rows, int channels, int vec, int dtype, int width, int grid_x, int grid_y) {
  if (rows < 1 || channels < 1 || (vec != 1 && vec != 8) || channels % vec != 0) return false;
  if (dtype != kBf16 && dtype != kFp16) return false;
  const int groups = channels / vec;
  return width >= 1 && width <= kThreads && grid_x >= 1 && grid_y >= 1 && grid_y <= 65535 &&
         static_cast<int64_t>(grid_y) * width >= groups;
}

// As kernel_means.cu: the library links its own CUDA runtime, whose current
// device is set to the tensors' only where it differs.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One launch on `stream` of device `device`: y from x, both [rows, channels]
// of dtype `dtype` (0 bf16, 1 fp16) in NHWC memory, and the float32
// bias[channels]; `vec` channels per access (8 or 1), `width` channel groups
// per block, a grid of grid_x x grid_y blocks (the wrapper's geometry).
// Returns the CUDA error code as an int, 0 on success.
int bias_act_forward(const void* x, const void* bias, void* y, long long rows, int channels,
                     int vec, int act, int dtype, int width, int grid_x, int grid_y, int device,
                     void* stream) {
  if (!valid(rows, channels, vec, dtype, width, grid_x, grid_y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBf16)
    err = vec == 8
              ? launch_forward<__nv_bfloat16, 8>(act, grid, s, x, bias, y, rows, channels, width)
              : launch_forward<__nv_bfloat16, 1>(act, grid, s, x, bias, y, rows, channels, width);
  else
    err = vec == 8 ? launch_forward<__half, 8>(act, grid, s, x, bias, y, rows, channels, width)
                   : launch_forward<__half, 1>(act, grid, s, x, bias, y, rows, channels, width);
  return static_cast<int>(err);
}

// gx from g and y as bias_act_forward lays them out. With `bias_grad`
// non-null, also the float32 gradient of the bias: each of the grid_x *
// grid_y blocks writes its sums into `partial` (grid_x x channels floats,
// the wrapper sizes it), then a second launch reduces them into
// bias_grad[channels]. Returns the CUDA error code as an int.
int bias_act_backward(const void* g, const void* y, void* gx, void* partial, void* bias_grad,
                      long long rows, int channels, int vec, int act, int dtype, int width,
                      int grid_x, int grid_y, int device, void* stream) {
  if (!valid(rows, channels, vec, dtype, width, grid_x, grid_y) ||
      (bias_grad != nullptr && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = bias_grad != nullptr ? static_cast<float*>(partial) : nullptr;
  if (dtype == kBf16)
    err = vec == 8 ? launch_backward<__nv_bfloat16, 8>(act, grid, s, g, y, gx, part, rows,
                                                       channels, width)
                   : launch_backward<__nv_bfloat16, 1>(act, grid, s, g, y, gx, part, rows,
                                                       channels, width);
  else
    err = vec == 8 ? launch_backward<__half, 8>(act, grid, s, g, y, gx, part, rows, channels,
                                                width)
                   : launch_backward<__half, 1>(act, grid, s, g, y, gx, part, rows, channels,
                                                width);
  if (err != cudaSuccess || bias_grad == nullptr) return static_cast<int>(err);
  bias_grad_finish<<<(channels + 31) / 32, kThreads, 0, s>>>(
      part, static_cast<float*>(bias_grad), grid_x, channels);
  return static_cast<int>(cudaGetLastError());
}

const char* bias_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
