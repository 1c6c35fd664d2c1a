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
// Two designs, chosen in msda_int8_fwd by D and alignment
// (msda_int8_fwd_design):
//
// D = 32 with an 8-byte aligned value, every call of the int8 main paths:
// a load-parallel gather on the layout of the bf16 forward's D = 32 design
// (ms_deform_attn_fwd.cu). One warp per (b, q, h), warps in (b, q, h)
// order.
//   * The warp reads the (b, q, h)'s L * P locations and weights once,
//     coalesced. Lane l works out sample l % 16 (its codes, row weights and
//     clamped corner rows) and the lanes that gather the sample take those
//     by shuffle: every lane computes one sample's codes, not two, and the
//     two IEEE divides and float-to-int conversions of a sample are most of
//     that work.
//   * A lane holds 8 int8 channels of a corner row (one 8-byte load); a
//     32-channel row is 4 lanes, so the warp is 8 groups and group g takes
//     the consecutive samples 2g, 2g + 1 of each 16: 8 loads in flight a
//     lane, all issued before any product, with clamped addresses and zero
//     codes and row weights for invalid corners instead of branches.
//   * q[x0] * c0 + q[x1] * c1 of 4 channels is two byte permutes and four
//     __dp4a: int8 times int8 into int32, exact as the integer products
//     were (the codes lie in [0, 127] for attention weights >= 0, which the
//     softmax gives).
//   * A group's samples lie in one level where P is even, so the group
//     keeps the level's float32 partial and scales it by s[b, h, l, :] /
//     127^2 when the level changes; the groups' rows are then summed by
//     xor shuffles and group 0 stores 8 channels a lane as vectors.
//
// Other D, or a misaligned value (tests only): the first port's kernel, one
// warp per (b, q, h), lane = channel (a loop covers D > 32), a 1-byte load
// per valid corner.
//
// What bounds it: at the encoder shape (B 8, Q = S = 23 205, H 8, D 32,
// L 4, P 4) the bytes are the int8 value (47.5 MB), loc (190 MB), attn
// (95 MB) and the bf16 output (95 MB): 0.128 ms at 3.35 TB/s. The gather
// reads 95 M corner rows of 32 bytes (3.04 GB) from L2, half the bf16
// forward's; the first design kept 1-2 scalar loads in flight a lane
// between dependent multiply-adds and took 4.8 ms a call.
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

// ---- D = 32: the load-parallel gather -------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kD32 = 32;
constexpr int kChunk = 16;       // samples whose locations a warp holds at once (2 floats a lane)
constexpr int kCh = 8;           // int8 channels a lane: one 8-byte load
constexpr int kLanesPerRow = kD32 / kCh;
constexpr int kGroups = 32 / kLanesPerRow;
constexpr int kPer = kChunk / kGroups;  // samples a group takes of a chunk

__device__ __forceinline__ void store_row(float* p, const float (&v)[kCh]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[kCh]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// acc_l[ch] += (q0[ch] * c0 + q1[ch] * c1) * r for the 8 channels of one
// corner row pair (columns x0, x1), the integer sum exact, every float
// operation rounded on its own
__device__ __forceinline__ void row_sum(float (&acc_l)[kCh], uint2 q0, uint2 q1, int cw_lo,
                                        int cw_hi, float r) {
  const uint32_t a[2] = {q0.x, q0.y}, b[2] = {q1.x, q1.y};
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int p_lo = (int)__byte_perm(a[w], b[w], 0x5140);  // bytes (a0, b0, a1, b1)
    const int p_hi = (int)__byte_perm(a[w], b[w], 0x7362);  // bytes (a2, b2, a3, b3)
    const int t[4] = {__dp4a(p_lo, cw_lo, 0), __dp4a(p_lo, cw_hi, 0),
                      __dp4a(p_hi, cw_lo, 0), __dp4a(p_hi, cw_hi, 0)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc_l[4 * w + k] = __fadd_rn(acc_l[4 * w + k], __fmul_rn((float)t[k], r));
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_int8_fwd_d32_kernel(const int8_t* __restrict__ value,  // (B, S, H, 32)
                         const float* __restrict__ scales,  // (B, H, L, 32)
                         const float* __restrict__ loc,     // (B, Q, H, L, P, 2)
                         const float* __restrict__ attn,    // (B, Q, H, L, P)
                         T* __restrict__ out,               // (B, Q, H, 32)
                         int B, int S, int Q, int H, int P, Levels lv) {
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t b = warp / ((int64_t)Q * H);
  const int grp = lane / kLanesPerRow;
  const int sub = lane % kLanesPerRow;
  const int LP = lv.n * P;
  const float* wloc = loc + warp * LP * 2;
  const float* wattn = attn + warp * LP;
  const int64_t row = (int64_t)H * kD32;  // stride of one token in value
  const int8_t* vbh = value + b * (int64_t)S * row + (int64_t)h * kD32 + sub * kCh;
  const float* sbh = scales + (b * H + h) * (int64_t)lv.n * kD32 + sub * kCh;
  const float inv127sq = 1.0f / (127.0f * 127.0f);

  float acc[kCh], acc_l[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = acc_l[c] = 0.f;
  int cur = -1;  // the level acc_l sums

  for (int k0 = 0; k0 < LP; k0 += kChunk) {
    // lane l holds location float 2 k0 + l and weight k0 + l % 16
    const float my_loc = 2 * k0 + lane < 2 * LP ? __ldg(wloc + 2 * k0 + lane) : 0.f;
    const float my_attn = k0 + (lane & 15) < LP ? __ldg(wattn + k0 + (lane & 15)) : 0.f;
    // lane l works out sample l % 16 (lanes l and l + 16 alike): its codes,
    // row weights, level and clamped corner tokens; the group lanes that
    // gather it take them by shuffle
    int s_cw, s_lvl, s_tok[4];
    float s_r0, s_r1;
    {
      const int kl = lane & 15;
      const float lx = __shfl_sync(kFull, my_loc, 2 * kl);
      const float ly = __shfl_sync(kFull, my_loc, 2 * kl + 1);
      const float a = my_attn;
      const bool live = k0 + kl < LP;
      const int l = live ? (k0 + kl) / P : 0;
      s_lvl = live ? l : -1;
      int Hl = lv.h[0], Wl = lv.w[0], start = lv.start[0];
#pragma unroll
      for (int j = 1; j < kMaxLevels; ++j)
        if (j == l) Hl = lv.h[j], Wl = lv.w[j], start = lv.start[j];
      const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = __fsub_rn(x, x0);
      const float fy = __fsub_rn(y, y0);
      // corner validity on float coords, before any int conversion
      const bool vx0 = x0 >= 0.f && x0 <= (float)(Wl - 1);
      const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= (float)(Wl - 1);
      const bool vy0 = live && y0 >= 0.f && y0 <= (float)(Hl - 1);
      const bool vy1 = live && y0 + 1.f >= 0.f && y0 + 1.f <= (float)(Hl - 1);
      // an invalid column gets code 0, an invalid row weight 0
      const float wx0 = vx0 ? __fmul_rn(__fsub_rn(1.f, fx), a) : 0.f;
      const float wx1 = vx1 ? __fmul_rn(fx, a) : 0.f;
      const float colmax = fmaxf(fmaxf(wx0, wx1), 1e-8f);
      const int c0 = __float2int_rn(__fmul_rn(__fdiv_rn(wx0, colmax), 127.f));
      const int c1 = __float2int_rn(__fmul_rn(__fdiv_rn(wx1, colmax), 127.f));
      s_cw = (c0 & 0xff) | (c1 & 0xff) << 8;  // bytes (c0, c1, 0, 0)
      s_r0 = vy0 ? __fmul_rn(__fsub_rn(1.f, fy), colmax) : 0.f;
      s_r1 = vy1 ? __fmul_rn(fy, colmax) : 0.f;
      // an invalid corner reads a clamped address inside the level
      const int ix0 = (int)fminf(fmaxf(x0, 0.f), (float)(Wl - 1));
      const int ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(Wl - 1));
      const int iy0 = (int)fminf(fmaxf(y0, 0.f), (float)(Hl - 1));
      const int iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(Hl - 1));
      s_tok[0] = start + iy0 * Wl + ix0;
      s_tok[1] = start + iy0 * Wl + ix1;
      s_tok[2] = start + iy1 * Wl + ix0;
      s_tok[3] = start + iy1 * Wl + ix1;
    }
    uint2 raw[kPer][4];
    int cw[kPer], lvl[kPer];
    float r0[kPer], r1[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kl = grp * kPer + i;  // the sample within the chunk
      cw[i] = __shfl_sync(kFull, s_cw, kl);
      lvl[i] = __shfl_sync(kFull, s_lvl, kl);
      r0[i] = __shfl_sync(kFull, s_r0, kl);
      r1[i] = __shfl_sync(kFull, s_r1, kl);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int8_t* src = vbh + (int64_t)__shfl_sync(kFull, s_tok[c], kl) * row;
        raw[i][c] = __ldg(reinterpret_cast<const uint2*>(src));
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (lvl[i] < 0) continue;  // past the last sample
      if (lvl[i] != cur) {  // a new level: scale the finished one into acc
        if (cur >= 0) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const float descale = __fmul_rn(__ldg(sbh + cur * kD32 + c), inv127sq);
            acc[c] = __fadd_rn(acc[c], __fmul_rn(acc_l[c], descale));
            acc_l[c] = 0.f;
          }
        }
        cur = lvl[i];
      }
      row_sum(acc_l, raw[i][0], raw[i][1], cw[i], cw[i] << 16, r0[i]);
      row_sum(acc_l, raw[i][2], raw[i][3], cw[i], cw[i] << 16, r1[i]);
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float descale = __fmul_rn(__ldg(sbh + cur * kD32 + c), inv127sq);
      acc[c] = __fadd_rn(acc[c], __fmul_rn(acc_l[c], descale));
    }
  }
  // sum the groups' partial rows: lanes with one `sub` hold the same channels
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(kFull, acc[c], o));
  }
  if (grp == 0) store_row(out + warp * kD32 + sub * kCh, acc);
}

// the design msda_int8_fwd launches: 1 the D = 32 gather (its 8-byte loads
// need an 8-byte aligned value), 0 the channel loop
int design(int D, const void* value) {
  return D == kD32 && reinterpret_cast<uintptr_t>(value) % 8 == 0 ? 1 : 0;
}

template <typename T>
cudaError_t launch(const void* value, const void* scales, const void* loc,
                   const void* attn, void* out, int B, int S, int Q, int H,
                   int D, int P, const Levels& lv, cudaStream_t stream) {
  const int64_t warps = (int64_t)B * Q * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (design(D, value) == 1) {
    msda_int8_fwd_d32_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const int8_t*>(value), static_cast<const float*>(scales),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<T*>(out), B, S, Q, H, P, lv);
  } else {
    msda_int8_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const int8_t*>(value), static_cast<const float*>(scales),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<T*>(out), B, S, Q, H, D, P, lv);
  }
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
  for (int l = 0; l < kMaxLevels; ++l) {  // unused levels repeat level 0
    const int k = l < n_levels ? l : 0;
    lv.h[l] = level_geom[3 * k];
    lv.w[l] = level_geom[3 * k + 1];
    lv.start[l] = level_geom[3 * k + 2];
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

// The design msda_int8_fwd launches for these arguments: 1 the D = 32
// gather, 0 the channel loop.
int msda_int8_fwd_design(int D, const void* value) { return design(D, value); }

const char* msda_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
