// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_v4_kernel` / `ms_deform_attn_v4`
// (rlipv2_tpu/ops/ms_deform_attn_v4.py:87, :170). The TPU kernel turns the
// bilinear gather into one-hot matmuls on the MXU because the TPU has no
// fast gather; this kernel computes the same function as a plain gather.
//
//   out[b, q, h, :] = sum_{l < L, p < P} attn[b, q, h, l, p] *
//                     bilinear(value[b, level l, :, h, :], loc[b, q, h, l, p])
//
// Sampling follows grid_sample(align_corners=False, padding_mode="zeros"):
// pixel coords are (loc.x * W - 0.5, loc.y * H - 0.5) and a corner outside the
// level contributes zero. Validity is tested on the float corner coords before
// any index is formed (rlipv2_tpu/ops/ms_deform_attn.py:74-95, :119-131).
//
// Two designs, chosen by D in msda_fwd:
//
// D = 32, every published config and every call of the main paths: a
// load-parallel gather. One warp per (b, q, h), warps in (b, q, h) order so
// that the blocks in flight share one image's value in L2.
//   * The warp reads the (b, q, h)'s L * P locations and weights once,
//     coalesced (one float a lane), and hands each sample's x, y and weight
//     to the lanes that need them by shuffle.
//   * A lane holds 16 bytes of a corner row: 8 bf16 or 4 float channels.
//     A 32-channel row is 4 lanes in bf16 (8 in float32), so the warp is 8
//     groups of 4 lanes (4 of 8) and group g takes samples g, g + 8 (g,
//     g + 4, g + 8, g + 12) of each 16.
//   * Every corner load of a lane is issued before any product: 8 (bf16)
//     or 16 (float32) independent 16-byte loads in flight a lane. A corner
//     outside its level gets a clamped address and a zero weight instead of
//     a branch.
//   * Products and sums in float32; the groups' partial rows are summed by
//     xor shuffles and group 0 stores the output row as 16-byte vectors.
//
// Other D (tests only): the first port's kernel, one warp per (b, q, h),
// lane = channel (a loop covers D > 32), a scalar load per valid corner.
//
// What bounds it: the gather. At 832x1344, batch 8, the encoder value is
// 8 * 23205 * 256 * 2 B = 95 MB in bf16, above the 50 MB L2, and every
// (q, h) reads 16 samples x 4 corners of 64 bytes from it at data-dependent
// addresses: 6.1 GB of corner rows a call, served mostly by L2 (or L1, where
// neighbouring queries sample the same rows), against the 475 MB that the
// HBM bound counts. The first port's kernel had one or two scalar loads in
// flight a warp and was bound by their latency (3.9 ms a call, 3.6 % of the
// HBM bound); this design keeps 8-16 vector loads in flight a lane, so the
// aim is the L2 side of the card.
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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const T* __restrict__ value,   // (B, S, H, D)
                const float* __restrict__ loc,  // (B, Q, H, L, P, 2)
                const float* __restrict__ attn, // (B, Q, H, L, P)
                T* __restrict__ out,            // (B, Q, H, D)
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
  const T* vbh = value + b * (int64_t)S * row + (int64_t)h * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const T* vl = vbh + (int64_t)lv.start[l] * row + d;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float a = wattn[k];
        // separately rounded multiply and subtract, as the plain version
        // computes them: a fused multiply-add would round x once, and at
        // W = 168 that moves the bilinear fraction by up to ~1e-5
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
        if (!active || !((vx0 || vx1) && (vy0 || vy1))) continue;
        const int ix = (int)x0;
        const int iy = (int)y0;
        const float wy0 = (1.f - fy) * a;
        const float wy1 = fy * a;
        if (vy0) {
          const T* r = vl + (int64_t)iy * Wl * row;
          if (vx0) acc += wy0 * (1.f - fx) * load_f32(r + (int64_t)ix * row);
          if (vx1) acc += wy0 * fx * load_f32(r + (int64_t)(ix + 1) * row);
        }
        if (vy1) {
          const T* r = vl + (int64_t)(iy + 1) * Wl * row;
          if (vx0) acc += wy1 * (1.f - fx) * load_f32(r + (int64_t)ix * row);
          if (vx1) acc += wy1 * fx * load_f32(r + (int64_t)(ix + 1) * row);
        }
      }
    }
    if (active) store(out + warp * D + d, acc);
  }
}

// ---- D = 32: the load-parallel gather ------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kD32 = 32;
constexpr int kChunk = 16;  // samples whose locations a warp holds at once (2 floats a lane)

// 16 bytes of a corner row as float32 channels
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
__device__ __forceinline__ void store_row(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_d32_kernel(const T* __restrict__ value,   // (B, S, H, 32)
                    const float* __restrict__ loc,  // (B, Q, H, L, P, 2)
                    const float* __restrict__ attn, // (B, Q, H, L, P)
                    T* __restrict__ out,            // (B, Q, H, 32)
                    int B, int S, int Q, int H, int P, Levels lv) {
  constexpr int kCh = 16 / sizeof(T);       // channels a lane: 8 bf16, 4 float
  constexpr int kLanesPerRow = kD32 / kCh;  // 4 bf16, 8 float
  constexpr int kGroups = 32 / kLanesPerRow;
  constexpr int kPer = kChunk / kGroups;    // samples a group takes of a chunk
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
  const T* vbh = value + b * (int64_t)S * row + (int64_t)h * kD32 + sub * kCh;

  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < LP; k0 += kChunk) {
    // lane l holds location float 2 k0 + l and weight k0 + l % 16
    const float my_loc = 2 * k0 + lane < 2 * LP ? __ldg(wloc + 2 * k0 + lane) : 0.f;
    const float my_attn = k0 + (lane & 15) < LP ? __ldg(wattn + k0 + (lane & 15)) : 0.f;
    uint4 raw[kPer][4];
    float wgt[kPer][4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int kl = grp + i * kGroups;  // the sample within the chunk
      const float lx = __shfl_sync(kFull, my_loc, 2 * kl);
      const float ly = __shfl_sync(kFull, my_loc, 2 * kl + 1);
      const float a = __shfl_sync(kFull, my_attn, kl);
      const bool live = k0 + kl < LP;
      const int l = live ? (k0 + kl) / P : 0;
      int Hl = lv.h[0], Wl = lv.w[0], start = lv.start[0];
#pragma unroll
      for (int j = 1; j < kMaxLevels; ++j)
        if (j == l) Hl = lv.h[j], Wl = lv.w[j], start = lv.start[j];
      // separately rounded multiply and subtract, as the plain version
      // computes them (an FMA moves the bilinear fraction by ~1e-5 at W = 168)
      const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float fx = x - x0;
      const float fy = y - y0;
      // corner validity on float coords, before any int conversion
      const bool vx0 = x0 >= 0.f && x0 <= (float)(Wl - 1);
      const bool vx1 = x0 + 1.f >= 0.f && x0 + 1.f <= (float)(Wl - 1);
      const bool vy0 = live && y0 >= 0.f && y0 <= (float)(Hl - 1);
      const bool vy1 = live && y0 + 1.f >= 0.f && y0 + 1.f <= (float)(Hl - 1);
      // an invalid corner reads a clamped address inside the level, weight 0
      const int ix0 = (int)fminf(fmaxf(x0, 0.f), (float)(Wl - 1));
      const int ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(Wl - 1));
      const int iy0 = (int)fminf(fmaxf(y0, 0.f), (float)(Hl - 1));
      const int iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(Hl - 1));
      const float wy0 = (1.f - fy) * a;
      const float wy1 = fy * a;
      wgt[i][0] = vy0 && vx0 ? wy0 * (1.f - fx) : 0.f;
      wgt[i][1] = vy0 && vx1 ? wy0 * fx : 0.f;
      wgt[i][2] = vy1 && vx0 ? wy1 * (1.f - fx) : 0.f;
      wgt[i][3] = vy1 && vx1 ? wy1 * fx : 0.f;
      const T* r0 = vbh + (int64_t)(start + iy0 * Wl) * row;
      const T* r1 = vbh + (int64_t)(start + iy1 * Wl) * row;
      raw[i][0] = __ldg(reinterpret_cast<const uint4*>(r0 + ix0 * row));
      raw[i][1] = __ldg(reinterpret_cast<const uint4*>(r0 + ix1 * row));
      raw[i][2] = __ldg(reinterpret_cast<const uint4*>(r1 + ix0 * row));
      raw[i][3] = __ldg(reinterpret_cast<const uint4*>(r1 + ix1 * row));
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[kCh];
        unpack(raw[i][c], v, T());
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) acc[ch] = fmaf(wgt[i][c], v[ch], acc[ch]);
      }
    }
  }
  // sum the groups' partial rows: lanes with one `sub` hold the same channels
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) acc[ch] += __shfl_xor_sync(kFull, acc[ch], o);
  }
  if (grp == 0) store_row(out + warp * kD32 + sub * kCh, acc);
}

// the design msda_fwd launches: 1 the D = 32 gather (its 16-byte loads need
// a 16-byte aligned value), 0 the channel loop
int design(int D, const void* value) {
  return D == kD32 && reinterpret_cast<uintptr_t>(value) % 16 == 0 ? 1 : 0;
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int B, int S, int Q, int H, int D, int P,
                   const Levels& lv, cudaStream_t stream) {
  const int64_t warps = (int64_t)B * Q * H;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (design(D, value) == 1) {
    msda_fwd_d32_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<T*>(out), B, S, Q, H, P, lv);
  } else {
    msda_fwd_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<T*>(out), B, S, Q, H, D, P, lv);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 value/out, 1 = bfloat16 value/out. loc and attn are
// float32. level_geom holds n_levels triples (h, w, start). Returns the CUDA
// error code of the launch (0 on success); the launch does not synchronise.
int msda_fwd(const void* value, const void* loc, const void* attn, void* out,
             int dtype, int B, int S, int Q, int H, int D, int n_levels, int P,
             const int* level_geom, void* stream) {
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
    err = launch<float>(value, loc, attn, out, B, S, Q, H, D, P, lv, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(value, loc, attn, out, B, S, Q, H, D, P, lv, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The design msda_fwd launches for these arguments: 1 the D = 32 gather, 0
// the channel loop.
int msda_fwd_design(int D, const void* value) { return design(D, value); }

const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
