// Swin window attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `fused_window_attention`
// (rlipv2_tpu/ops/window_attention.py:56, :145). For each window w and head
// h of the packed projection qkv (nWB, N, 3C), C = heads * 32:
//
//   S = Q K^T * 32^-1/2 + bias[h] (+ mask[w % nW])     float32
//   P = softmax(S) rounded to the qkv dtype
//   O = P V, summed in float32, stored in the qkv dtype at out[w, :, h*32:]
//
// with Q, K, V the head's 32 columns of the q, k and v thirds of qkv.
// Windows are B-major, so window w takes mask row w % nW. qkv is read in
// its packed layout: nothing is transposed or padded outside the kernel.
//
// Design: one block per (window, head). The block copies the head's K and
// V rows (N x 32 each) into shared memory as float32; K rows are padded to
// 33 floats so that lane j reading K[j][dd] hits 32 different banks. Each
// warp then takes query rows in turn: lane dd holds q[dd] and broadcasts it
// by shuffle, lane l keeps the scores of keys l, l + 32, ... in registers
// (N <= 160, five a lane), the softmax max and sum are warp reductions, and
// for P V lane dd accumulates output channel dd while each p_j is broadcast
// from the lane that holds it. The TPU kernel's grouping of G windows per
// grid step and its (h*N, N) VMEM score scratch have no purpose here: a
// block's scores never leave its registers.
//
// What bounds it: at the main path's shapes (Swin-L, 832x1344, batch 8,
// bf16) a forward moves 7.6 GB through its 24 calls, 2.27 ms at 3.35 TB/s,
// while its 0.54 TFLOP of matrix products would take 0.54 ms on the bf16
// tensor cores: by the card's peaks it is bound by bytes. This first version
// does the products as float32 FMAs outside the tensor cores, each behind a
// shuffle or a shared-memory load, and every query row re-reads K and V from
// shared memory; on an H100 (700 W) the 24 calls take ~60 ms, far from both
// HBM and the FMA peak. mma.sync or wgmma tiles for S and O, and several
// query rows a warp, are the next step.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (rlipv2_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;          // head dim of every published Swin spec
constexpr int kMaxN = 160;      // tokens a window: 12 x 12 = 144 and 7 x 7 = 49 fit
constexpr int kKeysPerLane = kMaxN / 32;
constexpr int kWarps = 8;
constexpr int kKStride = kD + 1;  // padded K row: no bank conflicts across keys
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attn_fwd_kernel(const T* __restrict__ qkv,     // (nWB, N, 3C)
                       const float* __restrict__ bias,  // (h, N, N)
                       const float* __restrict__ mask,  // (nW, N, N) or null
                       T* __restrict__ out,             // (nWB, N, C)
                       int N, int h, int nW, float scale) {
  __shared__ float ks[kMaxN * kKStride];
  __shared__ float vs[kMaxN * kD];

  const int head = blockIdx.x % h;
  const int64_t w = blockIdx.x / h;
  const int C = h * kD;
  const int64_t row = 3 * (int64_t)C;  // stride of one token in qkv
  const T* win = qkv + w * N * row + head * kD;

  for (int i = threadIdx.x; i < N * kD; i += blockDim.x) {
    const int j = i / kD;
    const int dd = i % kD;
    const T* r = win + j * row + dd;
    ks[j * kKStride + dd] = to_f32(r[C]);
    vs[j * kD + dd] = to_f32(r[2 * C]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h = bias + (int64_t)head * N * N;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w % nW) * N * N;
  T* out_w = out + w * N * C + head * kD;

  for (int r = warp; r < N; r += kWarps) {
    const float q = to_f32(win[r * row + lane]);
    // scores of keys lane, lane + 32, ...; a key >= N reads shared memory
    // that lies inside the arrays but may hold stale values, and its score
    // is dropped below
    float s[kKeysPerLane];
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < kD; ++dd) {
      const float qd = __shfl_sync(kFull, q, dd);
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) s[t] += qd * ks[(t * 32 + lane) * kKStride + dd];
    }

    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = t * 32 + lane;
      if (j < N) {
        float v = s[t] * scale + bias_h[r * N + j];
        if (mask_w != nullptr) v += mask_w[r * N + j];
        s[t] = v;
        m = fmaxf(m, v);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = t * 32 + lane;
      s[t] = j < N ? expf(s[t] - m) : 0.f;
      sum += s[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    // P in the qkv dtype, as the TPU kernel casts it before P V
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) s[t] = to_f32(from_f32<T>(s[t] / sum));

    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      if (t * 32 >= N) break;
      const int n_src = min(32, N - t * 32);  // the same in every lane
      for (int src = 0; src < n_src; ++src) {
        const float pj = __shfl_sync(kFull, s[t], src);
        acc += pj * vs[(t * 32 + src) * kD + lane];
      }
    }
    out_w[(int64_t)r * C + lane] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* bias, const void* mask, void* out, int nWB,
                   int N, int h, int nW, cudaStream_t stream) {
  const int64_t blocks = (int64_t)nWB * h;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float scale = 1.0f / sqrtf((float)kD);
  window_attn_fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), N, h, nW, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 qkv/out, 1 = bfloat16 qkv/out. bias (h, N, N) and mask
// (nW, N, N) are float32; mask may be null. Head dim 32, 1 <= N <= 160.
// Returns the CUDA error code of the launch (0 on success); the launch does
// not synchronise.
int window_attn_fwd(const void* qkv, const void* bias, const void* mask, void* out, int dtype,
                    int nWB, int N, int h, int nW, void* stream) {
  if (N < 1 || N > kMaxN || h < 1) return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (nW < 1 || nWB % nW != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(qkv, bias, mask, out, nWB, N, h, nW, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(qkv, bias, mask, out, nWB, N, h, nW, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
