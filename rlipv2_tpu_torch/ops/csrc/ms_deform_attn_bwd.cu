// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_v4_bwd_kernel` / `ms_deform_attn_v4_bwd`
// (rlipv2_tpu/ops/ms_deform_attn_v4.py:267, :624) together with the XLA vjp
// of `_separable_prepare` that turns its separable-weight grads into grads of
// the sampling locations and attention weights
// (rlipv2_tpu/ops/ms_deform_attn.py:243-273). The TPU kernel scatters through
// transposed one-hot matmuls over y-windows because the TPU has no scatter;
// on Hopper the scatter is a plain atomic add, and dloc / dattn come straight
// from the corner values.
//
// For one sample k = (b, q, h, l, p) with attention weight a, bilinear corner
// weights w_c(fx, fy) and corner rows v_c (zero weight where a corner lies
// outside the level), and the output cotangent g = grad_out[b, q, h, :]:
//
//   dvalue[b, start_l + idx_c, h, :] += a * w_c * g
//   dattn[k]    = sum_c w_c * <g, v_c>
//   dloc[k, 0]  = W_l * a * sum_c dw_c/dfx * <g, v_c>
//   dloc[k, 1]  = H_l * a * sum_c dw_c/dfy * <g, v_c>
//
// which is what autograd of `ms_deform_attn_plain` gives: x = loc.x * W - 0.5,
// fx = x - floor(x), floor has zero derivative, and an invalid corner
// contributes to nothing.
//
// Layout, mirroring the forward kernel: one warp per (b, q, h); lane =
// channel, with up to kMaxChunks chunks of 32 channels held in registers, so
// the grad_out row is read once and reused by every sample of the warp. The
// three per-sample dot products are reduced across the warp with
// __shfl_xor_sync and lane 0 writes dattn and dloc (float32). dvalue is
// accumulated with float32 atomics into a zeroed buffer that the wrapper
// casts to the value dtype afterwards: bf16 atomics would round every partial
// sum. The order of the atomic adds changes from run to run.
//
// What bounds it: the scatter. At 832x1344, batch 8, the encoder call issues
// B * Q * H * L * P * 4 * D = 3.0e9 float atomics into a 190 MB buffer (above
// the 50 MB L2) at data-dependent rows, plus the gathers of the forward.
// This first version is the simple, correct one: vector red.global.add on
// float32x4, an L2-friendly query order and shared-memory staging are left
// for later work.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (rlipv2_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxChunks = 4;  // D <= 128
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const T* __restrict__ value,     // (B, S, H, D)
                const float* __restrict__ loc,   // (B, Q, H, L, P, 2)
                const float* __restrict__ attn,  // (B, Q, H, L, P)
                const T* __restrict__ grad_out,  // (B, Q, H, D)
                float* __restrict__ dvalue,      // (B, S, H, D), zeroed
                float* __restrict__ dloc,        // (B, Q, H, L, P, 2)
                float* __restrict__ dattn,       // (B, Q, H, L, P)
                int B, int S, int Q, int H, int D, int P, Levels lv) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // the whole warp leaves together, so the shuffles below see 32 lanes
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t b = warp / ((int64_t)Q * H);
  const int LP = lv.n * P;
  const float* wloc = loc + warp * LP * 2;
  const float* wattn = attn + warp * LP;
  const int64_t row = (int64_t)H * D;  // stride of one token in value
  const int64_t base = b * (int64_t)S * row + (int64_t)h * D;
  const T* vbh = value + base;
  float* dvbh = dvalue + base;
  const int chunks = (D + 31) >> 5;

  float g[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = c * 32 + lane;
    g[c] = (c < chunks && d < D) ? load_f32(grad_out + warp * D + d) : 0.f;
  }

  for (int l = 0; l < lv.n; ++l) {
    const int Hl = lv.h[l];
    const int Wl = lv.w[l];
    const int64_t start = (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float a = wattn[k];
      // the forward's rounding: separately rounded multiply and subtract
      const float x = __fsub_rn(__fmul_rn(wloc[2 * k], (float)Wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(wloc[2 * k + 1], (float)Hl), 0.5f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = x - x0;
      const float fy = y - y0;
      // corner validity on float coords, before any int conversion
      const bool vx0 = x0 >= 0.f && x0 <= (float)(Wl - 1);
      const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= (float)(Wl - 1);
      const bool vy0 = y0 >= 0.f && y0 <= (float)(Hl - 1);
      const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f <= (float)(Hl - 1);
      // corners (x0, y0), (x1, y0), (x0, y1), (x1, y1)
      const bool valid[4] = {vx0 && vy0, vx1 && vy0, vx0 && vy1, vx1 && vy1};
      const float w[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                          (1.f - fx) * fy, fx * fy};
      const float dwdx[4] = {-(1.f - fy), 1.f - fy, -fy, fy};
      const float dwdy[4] = {-(1.f - fx), -fx, 1.f - fx, fx};
      int64_t off[4] = {0, 0, 0, 0};
      if (valid[0] || valid[1] || valid[2] || valid[3]) {
        const int64_t ix = (int64_t)x0;
        const int64_t iy = (int64_t)y0;
        off[0] = start + (iy * Wl + ix) * row;
        off[1] = off[0] + row;
        off[2] = off[0] + (int64_t)Wl * row;
        off[3] = off[2] + row;
      }
      float t_attn = 0.f, t_x = 0.f, t_y = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = c * 32 + lane;
        if (c >= chunks || d >= D) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!valid[j]) continue;
          const float gv = g[c] * load_f32(vbh + off[j] + d);
          t_attn += w[j] * gv;
          t_x += dwdx[j] * gv;
          t_y += dwdy[j] * gv;
          atomicAdd(dvbh + off[j] + d, a * w[j] * g[c]);
        }
      }
      t_attn = warp_sum(t_attn);
      t_x = warp_sum(t_x);
      t_y = warp_sum(t_y);
      if (lane == 0) {
        dattn[warp * LP + k] = t_attn;
        dloc[(warp * LP + k) * 2] = (float)Wl * a * t_x;
        dloc[(warp * LP + k) * 2 + 1] = (float)Hl * a * t_y;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* grad_out, float* dvalue, float* dloc,
                   float* dattn, int B, int S, int Q, int H, int D, int P,
                   const Levels& lv, cudaStream_t stream) {
  const int64_t warps = (int64_t)B * Q * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  msda_bwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(grad_out), dvalue,
      dloc, dattn, B, S, Q, H, D, P, lv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 value/grad_out, 1 = bfloat16 value/grad_out. loc, attn,
// dvalue (zeroed by the caller), dloc and dattn are float32. level_geom holds
// n_levels triples (h, w, start). Returns the CUDA error code of the launch
// (0 on success); the launch does not synchronise.
int msda_bwd(const void* value, const void* loc, const void* attn,
             const void* grad_out, void* dvalue, void* dloc, void* dattn,
             int dtype, int B, int S, int Q, int H, int D, int n_levels, int P,
             const int* level_geom, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_geom[3 * l];
    lv.w[l] = level_geom[3 * l + 1];
    lv.start[l] = level_geom[3 * l + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(value, loc, attn, grad_out, dv, dl, da, B, S, Q, H, D,
                        P, lv, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(value, loc, attn, grad_out, dv, dl, da, B, S,
                                Q, H, D, P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* msda_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
