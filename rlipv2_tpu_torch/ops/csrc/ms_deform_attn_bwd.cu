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
// Two designs, chosen in msda_bwd by D and alignment (msda_bwd_design):
//
// D = 32 with 16-byte aligned value, grad_out and dvalue, every call of the
// train step: a load-parallel gather and vector scatter, on the layout of
// the forward's D = 32 gather (ms_deform_attn_fwd.cu). One warp per
// (b, q, h), warps in (b, q, h) order so that the blocks in flight share
// one image's value and float32 dvalue (11.9 MB and 23.8 MB at the encoder
// shape) in L2.
//   * The warp reads the (b, q, h)'s L * P locations and weights once,
//     coalesced, and hands them out by shuffle; a lane reads its 16 bytes of
//     the cotangent row once.
//   * A lane holds 16 bytes of a corner row: 8 bf16 or 4 float channels; a
//     32-channel row is 4 lanes in bf16 (8 in float32), so the warp is 8
//     groups (4) and group g takes the consecutive samples g * n .. g * n +
//     n - 1 of each 16 (n = 2 in bf16, 4 in float32). Every corner load of
//     a lane is issued before any product; an invalid corner reads a
//     clamped address with zero weights instead of a branch.
//   * The three dot products of a sample, <g, v_c> weighted for dattn and
//     the two dloc terms, are summed over the lane's channels and then over
//     the group's lanes by 2 (float32: 3) xor shuffles, not across the warp.
//     The per-sample results are gathered by shuffle to lanes in sample
//     order and stored as coalesced rows of dattn and dloc.
//   * dvalue: one 16-byte float32x4 reduction (REDG.F32x4, CUDA's
//     atomicAdd on float4) per 4 channels of a valid corner, where the
//     first design issues 32 scalar atomics per corner row. In bf16 a lane
//     also holds the cotangent in a second layout, 4 channels from each
//     half of the row, so that each reduction instruction of a group covers
//     64 contiguous bytes (two whole sectors) rather than half of four.
//   * In bf16, samples of the warp that land on one corner row share one
//     reduction (their coefficients of the same cotangent add): a lane's
//     two samples, then the two groups that hold a level's four points.
//
// Other D, or a misaligned pointer (tests only): the first port's kernel.
// One warp per (b, q, h); lane = channel, with up to kMaxChunks chunks of
// 32 channels held in registers. The three per-sample dot products are
// reduced across the warp with __shfl_xor_sync, lane 0 writes dattn and
// dloc, and dvalue takes a scalar float32 atomic per channel and corner.
//
// Both accumulate dvalue in float32, in a zeroed buffer that the wrapper
// casts to the value dtype afterwards: bf16 atomics would round every
// partial sum. The order of the atomic adds changes from run to run.
//
// What bounds it: the scatter. At 832x1344, batch 8, the encoder call
// reduces B * Q * H * L * P * 4 corner rows of 32 float32 (12.2 GB) into a
// 190 MB dvalue at data-dependent rows, besides the forward's 6.1 GB of
// gathered bf16 corner rows: the L2 side, not HBM (855 MB), sets the
// floor. The first design issued 3.0e9 scalar atomics behind 4 loads in
// flight a warp; the D = 32 design issues 16-byte reductions behind 8
// (float32: 16) loads in flight a lane, and the reductions take most of its
// time (PERF.md has the measurements).
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

// ---- D = 32: the load-parallel gather and vector scatter -----------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kD32 = 32;
constexpr int kChunk = 16;  // samples whose locations a warp holds at once (2 floats a lane)

// 16 bytes of a row as float32 channels
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4], float) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 channels of a row as float32 (8 bytes of bf16, 16 of float32)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_d32_kernel(const T* __restrict__ value,     // (B, S, H, 32)
                    const float* __restrict__ loc,   // (B, Q, H, L, P, 2)
                    const float* __restrict__ attn,  // (B, Q, H, L, P)
                    const T* __restrict__ grad_out,  // (B, Q, H, 32)
                    float* __restrict__ dvalue,      // (B, S, H, 32), zeroed
                    float* __restrict__ dloc,        // (B, Q, H, L, P, 2)
                    float* __restrict__ dattn,       // (B, Q, H, L, P)
                    int B, int S, int Q, int H, int P, Levels lv) {
  constexpr int kCh = 16 / sizeof(T);       // channels a lane: 8 bf16, 4 float
  constexpr int kLanesPerRow = kD32 / kCh;  // 4 bf16, 8 float
  constexpr int kGroups = 32 / kLanesPerRow;
  constexpr int kPer = kChunk / kGroups;    // samples a group takes of a chunk
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // the whole warp leaves together, so the shuffles below see 32 lanes
  if (warp >= (int64_t)B * Q * H) return;
  const int h = (int)(warp % H);
  const int64_t b = warp / ((int64_t)Q * H);
  const int grp = lane / kLanesPerRow;
  const int sub = lane % kLanesPerRow;
  const int LP = lv.n * P;
  const float* wloc = loc + warp * LP * 2;
  const float* wattn = attn + warp * LP;
  const int64_t row = (int64_t)H * kD32;  // stride of one token
  const T* vbh = value + b * (int64_t)S * row + (int64_t)h * kD32 + sub * kCh;

  // the cotangent twice: g in the gather's layout (channels sub * kCh ..
  // + kCh) for the dot products, gs in the scatter's (float4 j of a lane
  // holds channels (j * kLanesPerRow + sub) * 4 .. + 4) so that each
  // reduction instruction of a group covers whole 32-byte sectors of the
  // dvalue row
  float g[kCh], gs[kCh / 4][4];
  unpack(__ldg(reinterpret_cast<const uint4*>(grad_out + warp * kD32 + sub * kCh)), g, T());
#pragma unroll
  for (int j = 0; j < kCh / 4; ++j)
    load4(grad_out + warp * kD32 + (j * kLanesPerRow + sub) * 4, gs[j]);
  float* dvs = dvalue + b * (int64_t)S * row + (int64_t)h * kD32 + sub * 4;

  for (int k0 = 0; k0 < LP; k0 += kChunk) {
    // lane l holds location float 2 k0 + l and weight k0 + l % 16
    const float my_loc = 2 * k0 + lane < 2 * LP ? __ldg(wloc + 2 * k0 + lane) : 0.f;
    const float my_attn = k0 + (lane & 15) < LP ? __ldg(wattn + k0 + (lane & 15)) : 0.f;
    uint4 raw[kPer][4];
    int tok[kPer][4];     // corner tokens of the (b, h) slice, clamped
    float fx[kPer], fy[kPer], a[kPer], wl[kPer], hl[kPer];
    unsigned ok[kPer];    // bit c: corner c lies inside its level
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kl = grp * kPer + i;  // the sample within the chunk
      const float lx = __shfl_sync(kFull, my_loc, 2 * kl);
      const float ly = __shfl_sync(kFull, my_loc, 2 * kl + 1);
      a[i] = __shfl_sync(kFull, my_attn, kl);
      const bool live = k0 + kl < LP;
      const int l = live ? (k0 + kl) / P : 0;
      int Hl = lv.h[0], Wl = lv.w[0], start = lv.start[0];
#pragma unroll
      for (int j = 1; j < kMaxLevels; ++j)
        if (j == l) Hl = lv.h[j], Wl = lv.w[j], start = lv.start[j];
      wl[i] = (float)Wl;
      hl[i] = (float)Hl;
      // the forward's rounding: separately rounded multiply and subtract
      const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      fx[i] = x - x0;
      fy[i] = y - y0;
      // corner validity on float coords, before any int conversion
      const bool vx0 = x0 >= 0.f && x0 <= (float)(Wl - 1);
      const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= (float)(Wl - 1);
      const bool vy0 = live && y0 >= 0.f && y0 <= (float)(Hl - 1);
      const bool vy1 = live && y0 + 1.f >= 0.f && y0 + 1.f <= (float)(Hl - 1);
      ok[i] = (vy0 && vx0 ? 1u : 0u) | (vy0 && vx1 ? 2u : 0u) | (vy1 && vx0 ? 4u : 0u) |
              (vy1 && vx1 ? 8u : 0u);
      // an invalid corner reads a clamped address inside the level
      const int ix0 = (int)fminf(fmaxf(x0, 0.f), (float)(Wl - 1));
      const int ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(Wl - 1));
      const int iy0 = (int)fminf(fmaxf(y0, 0.f), (float)(Hl - 1));
      const int iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(Hl - 1));
      tok[i][0] = start + iy0 * Wl + ix0;
      tok[i][1] = start + iy0 * Wl + ix1;
      tok[i][2] = start + iy1 * Wl + ix0;
      tok[i][3] = start + iy1 * Wl + ix1;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        raw[i][c] = __ldg(reinterpret_cast<const uint4*>(vbh + (int64_t)tok[i][c] * row));
    }
    // the scatter of sample i, corner c is coef[i][c] * g into the corner
    // row tok[i][c]: every sample of the warp scales the same cotangent, so
    // samples that land on one row can share one reduction by adding their
    // coefficients. In bf16 (2 samples a lane, and with P = 4 the group
    // grp ^ 1 holding the level's other 2 points) a lane first takes its
    // second sample's rows that equal rows of its first, then the even group
    // of a pair takes the odd group's rows that equal its own (corner by
    // corner), and the lane that gave a row away skips its reduction. At
    // uniform locations nothing is shared and this costs no time; where the
    // points of a level lie within a pixel or two, it removes a third of
    // the reductions and more.
    float coef[kPer][4];
    unsigned red[kPer];  // bit c: reduce corner c of sample i
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float gx = 1.f - fx[i], gy = 1.f - fy[i];
      coef[i][0] = a[i] * (gx * gy);
      coef[i][1] = a[i] * (fx[i] * gy);
      coef[i][2] = a[i] * (gx * fy[i]);
      coef[i][3] = a[i] * (fx[i] * fy[i]);
      red[i] = ok[i];
    }
    if (kPer == 2) {
#pragma unroll
      for (int c1 = 0; c1 < 4; ++c1)
#pragma unroll
        for (int c0 = 0; c0 < 4; ++c0)
          if ((red[1] >> c1 & 1u) && (red[0] >> c0 & 1u) && tok[1][c1] == tok[0][c0]) {
            coef[0][c0] += coef[1][c1];
            red[1] &= ~(1u << c1);
          }
      const bool even = (grp & 1) == 0;
      int pkey[kPer][4];
      float pcoef[kPer][4];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pkey[i][c] = __shfl_xor_sync(kFull, (red[i] >> c & 1u) ? tok[i][c] : -1, kLanesPerRow);
          pcoef[i][c] = __shfl_xor_sync(kFull, coef[i][c], kLanesPerRow);
        }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            if ((red[i] >> c & 1u) && pkey[j][c] == tok[i][c]) {
              if (even) coef[i][c] += pcoef[j][c];
              else red[i] &= ~(1u << c);
            }
    }
    float t_attn[kPer], t_x[kPer], t_y[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float gx = 1.f - fx[i], gy = 1.f - fy[i];
      // corners (x0, y0), (x1, y0), (x0, y1), (x1, y1)
      const float w[4] = {gx * gy, fx[i] * gy, gx * fy[i], fx[i] * fy[i]};
      const float dwdx[4] = {-gy, gy, -fy[i], fy[i]};
      const float dwdy[4] = {-gx, -fx[i], gx, fx[i]};
      t_attn[i] = t_x[i] = t_y[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = ok[i] >> c & 1u;
        float v[kCh];
        unpack(raw[i][c], v, T());
        float dot = 0.f;
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) dot = fmaf(g[ch], v[ch], dot);
        dot = valid ? dot : 0.f;  // a select, not a branch: the group stays converged
        t_attn[i] += w[c] * dot;
        t_x[i] += dwdx[c] * dot;
        t_y[i] += dwdy[c] * dot;
        if (red[i] >> c & 1u) {
          const float aw = coef[i][c];
          float* dst = dvs + (int64_t)tok[i][c] * row;
#pragma unroll
          for (int j = 0; j < kCh / 4; ++j)
            atomicAdd(reinterpret_cast<float4*>(dst + j * kLanesPerRow * 4),
                      make_float4(aw * gs[j][0], aw * gs[j][1], aw * gs[j][2], aw * gs[j][3]));
        }
      }
    }
    // the group's lanes hold the sample's channels: sum them, every lane of
    // the group ends with the totals
#pragma unroll
    for (int o = 1; o < kLanesPerRow; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        t_attn[i] += __shfl_xor_sync(kFull, t_attn[i], o);
        t_x[i] += __shfl_xor_sync(kFull, t_x[i], o);
        t_y[i] += __shfl_xor_sync(kFull, t_y[i], o);
      }
    }
    // gather to lanes in sample order: lane l < 16 stores dattn of sample
    // k0 + l, lane l stores dloc float 2 k0 + l (sample l / 2, x or y)
    const int ka = lane & 15, kd = lane >> 1;
    float da = 0.f, dl = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float va = __shfl_sync(kFull, t_attn[i], (ka / kPer) * kLanesPerRow);
      const float vx = __shfl_sync(kFull, wl[i] * a[i] * t_x[i], (kd / kPer) * kLanesPerRow);
      const float vy = __shfl_sync(kFull, hl[i] * a[i] * t_y[i], (kd / kPer) * kLanesPerRow);
      if (ka % kPer == i) da = va;
      if (kd % kPer == i) dl = (lane & 1) ? vy : vx;
    }
    if (lane < 16 && k0 + lane < LP) dattn[warp * LP + k0 + lane] = da;
    if (2 * k0 + lane < 2 * LP) dloc[warp * LP * 2 + 2 * k0 + lane] = dl;
  }
}

// the design msda_bwd launches: 1 the D = 32 gather and vector scatter (its
// 16-byte loads and reductions need 16-byte aligned value, grad_out and
// dvalue), 0 the channel loop
int design(int D, const void* value, const void* grad_out, const void* dvalue) {
  const bool aligned = reinterpret_cast<uintptr_t>(value) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(grad_out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dvalue) % 16 == 0;
  return D == kD32 && aligned ? 1 : 0;
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
  if (design(D, value, grad_out, dvalue) == 1) {
    msda_bwd_d32_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const T*>(grad_out), dvalue,
        dloc, dattn, B, S, Q, H, P, lv);
  } else {
    msda_bwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<const T*>(grad_out), dvalue,
        dloc, dattn, B, S, Q, H, D, P, lv);
  }
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
  for (int l = 0; l < kMaxLevels; ++l) {  // unused levels repeat level 0
    const int k = l < n_levels ? l : 0;
    lv.h[l] = level_geom[3 * k];
    lv.w[l] = level_geom[3 * k + 1];
    lv.start[l] = level_geom[3 * k + 2];
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

// The design msda_bwd launches for these arguments: 1 the D = 32 gather and
// vector scatter, 0 the channel loop.
int msda_bwd_design(int D, const void* value, const void* grad_out, const void* dvalue) {
  return design(D, value, grad_out, dvalue);
}

const char* msda_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
