// int8 multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_v4_int8_kernel` / `ms_deform_attn_v4_int8`
// (rlipv2_tpu/ops/ms_deform_attn_v4.py:843, :941), the opt-in quantized
// inference path (impl "pallas_int8"). It computes that kernel's function,
// not its design: the TPU kernel builds int8 one-hot column mixers so that
// the int8 MXU does the gather; here the gather is a plain load.
//
// Inputs: the value already quantized by `quantize_value_int8`
// (rlipv2_tpu_torch/ops/ms_deform_attn.py) to int8 codes q in the
// (B, S, H, D) layout, with float32 scales s of shape (B, H, L, D), one per
// (batch, head, level, channel); loc (B, Q, H, L, P, 2) and attn
// (B, Q, H, L, P) float32. For each (b, q, h, l, p), as `_separable_prepare`
// and the TPU kernel form them:
//
//   x = loc.x * W - 0.5, x0 = floor(x), fx = x - x0 (y likewise)
//   wx0 = (1 - fx) * attn, wx1 = fx * attn  (0 for a column outside)
//   wy0 = 1 - fy, wy1 = fy                  (0 for a row outside)
//   colmax = max(wx0, wx1, 1e-8)
//   c0 = rint(wx0 / colmax * 127), c1 = rint(wx1 / colmax * 127)
//   r0 = wy0 * colmax, r1 = wy1 * colmax
//
// and the output is
//
//   out[b, q, h, d] = sum_l s[b, h, l, d] / 127^2 *
//       sum_p sum_{row} r_row * (q[row, x0, d] * c0 + q[row, x1, d] * c1)
//
// with the integer products exact, each level summed in float32, and a
// corner outside its level contributing 0. rint rounds half to even, as
// jnp.round does; every multiply, subtract and divide is rounded on its own
// (no FMA contraction), so the codes are the plain version's.
//
// Layout: one warp per (b, q, h), lane = channel (a loop covers D > 32), as
// in ms_deform_attn_fwd.cu. A corner's 32 int8 channels are one 32-byte
// sector, where the bf16 kernel reads two.
//
// What bounds it: at the encoder shape (B 8, Q = S = 23 205, H 8, D 32,
// L 4, P 4) the bytes are the int8 value (47.5 MB), loc (190 MB), attn
// (95 MB) and the bf16 output (95 MB): 0.128 ms at 3.35 TB/s. Like the exact
// kernel it is a gather at data-dependent addresses, limited by load latency
// rather than by bytes; this first version is the simple, correct one.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (rlipv2_tpu_torch/ops/cuda_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int load_code(const int8_t* p) {
  return (int)__ldg(reinterpret_cast<const signed char*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_int8_fwd_kernel(const int8_t* __restrict__ value,   // (B, S, H, D)
                     const float* __restrict__ scales,   // (B, H, L, D)
                     const float* __restrict__ loc,      // (B, Q, H, L, P, 2)
                     const float* __restrict__ attn,     // (B, Q, H, L, P)
                     T* __restrict__ out,                // (B, Q, H, D)
                     int B, int S, int Q, int H, int D, int P, Levels lv) {
  const int64_t warp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * Q * H) return;
  // warp enumerates (b, q, h) in the row-major order of loc/attn/out
  const int h = (int)(warp % H);
  const int64_t b = warp / ((int64_t)Q * H);
  const int LP = lv.n * P;
  const float* wloc = loc + warp * LP * 2;
  const float* wattn = attn + warp * LP;
  const int64_t row = (int64_t)H * D;  // stride of one token in value
  const int8_t* vbh = value + b * (int64_t)S * row + (int64_t)h * D;
  const float* sbh = scales + (b * H + h) * (int64_t)lv.n * D;
  const float inv127sq = 1.0f / (127.0f * 127.0f);

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const int8_t* vl = vbh + (int64_t)lv.start[l] * row + d;
      float acc_l = 0.f;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float a = wattn[k];
        const float x = __fsub_rn(__fmul_rn(wloc[2 * k], (float)Wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(wloc[2 * k + 1], (float)Hl), 0.5f);
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        const float fx = __fsub_rn(x, x0);
        const float fy = __fsub_rn(y, y0);
        // corner validity on float coords, before any int conversion
        const bool vx0 = x0 >= 0.f && x0 <= (float)(Wl - 1);
        const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= (float)(Wl - 1);
        const bool vy0 = y0 >= 0.f && y0 <= (float)(Hl - 1);
        const bool vy1 = y0 + 1.f >= 0.f && y0 + 1.f <= (float)(Hl - 1);
        if (!active || !((vx0 || vx1) && (vy0 || vy1))) continue;
        const float wx0 = vx0 ? __fmul_rn(__fsub_rn(1.f, fx), a) : 0.f;
        const float wx1 = vx1 ? __fmul_rn(fx, a) : 0.f;
        const float colmax = fmaxf(fmaxf(wx0, wx1), 1e-8f);
        const int c0 = __float2int_rn(__fmul_rn(__fdiv_rn(wx0, colmax), 127.f));
        const int c1 = __float2int_rn(__fmul_rn(__fdiv_rn(wx1, colmax), 127.f));
        const int ix = (int)x0;
        const int iy = (int)y0;
        if (vy0) {
          const int8_t* r = vl + (int64_t)iy * Wl * row;
          int t = 0;
          if (vx0) t += load_code(r + (int64_t)ix * row) * c0;
          if (vx1) t += load_code(r + (int64_t)(ix + 1) * row) * c1;
          acc_l = __fadd_rn(acc_l, __fmul_rn((float)t, __fmul_rn(__fsub_rn(1.f, fy), colmax)));
        }
        if (vy1) {
          const int8_t* r = vl + (int64_t)(iy + 1) * Wl * row;
          int t = 0;
          if (vx0) t += load_code(r + (int64_t)ix * row) * c0;
          if (vx1) t += load_code(r + (int64_t)(ix + 1) * row) * c1;
          acc_l = __fadd_rn(acc_l, __fmul_rn((float)t, __fmul_rn(fy, colmax)));
        }
      }
      if (active) {
        const float descale = __fmul_rn(__ldg(sbh + (int64_t)l * D + d), inv127sq);
        acc = __fadd_rn(acc, __fmul_rn(acc_l, descale));
      }
    }
    if (active) store(out + warp * D + d, acc);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* scales, const void* loc,
                   const void* attn, void* out, int B, int S, int Q, int H,
                   int D, int P, const Levels& lv, cudaStream_t stream) {
  const int64_t warps = (int64_t)B * Q * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  msda_int8_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int8_t*>(value), static_cast<const float*>(scales),
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<T*>(out), B, S, Q, H, D, P, lv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 output, 1 = bfloat16 output (the dtype of the value
// before quantization). value is int8 (B, S, H, D); scales, loc and attn
// are float32. level_geom holds n_levels triples (h, w, start). Returns the
// CUDA error code of the launch (0 on success); the launch does not
// synchronise.
int msda_int8_fwd(const void* value, const void* scales, const void* loc,
                  const void* attn, void* out, int dtype, int B, int S, int Q,
                  int H, int D, int n_levels, int P, const int* level_geom,
                  void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_geom[3 * l];
    lv.w[l] = level_geom[3 * l + 1];
    lv.start[l] = level_geom[3 * l + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(value, scales, loc, attn, out, B, S, Q, H, D, P, lv, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(value, scales, loc, attn, out, B, S, Q, H, D,
                                P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* msda_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
