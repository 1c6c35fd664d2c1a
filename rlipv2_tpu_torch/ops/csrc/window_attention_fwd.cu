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
// Two designs, chosen by dtype in window_attn_fwd:
//
// bfloat16, the main path (Swin-L runs its blocks under bf16 autocast): a
// flash-attention-2 style tile kernel on the tensor cores, in one pass (a
// window's N <= 160 scores a row fit in registers, so no online softmax).
//   * Grid: one block per (head, window group). With a mask, the group of
//     block (head, m) is the windows w = m, m + nW, ... (one per image), so
//     every window of the block takes the same mask window m; without one,
//     up to kWindowsPerBlock windows m, m + stride, .... The block stages
//     the head's bias and, where it fits, the mask window in dynamic shared
//     memory once, in the accumulator fragments' order, with -inf on padded
//     keys: each (window, head) then reads them with one conflict-free
//     16-byte load a fragment instead of 166 KB from L2.
//   * Staging: each window's Q, K and V head slices (64 contiguous bytes a
//     token) are copied into shared memory as bf16 by cp.async, 16 bytes a
//     thread, into a double buffer, so the next window's copy overlaps this
//     window's products. Rows are padded to Np = 16 * ceil(N / 16) with
//     zeros (144 -> 144, 49 -> 64); the 16-byte chunks of a row are XOR
//     swizzled so that ldmatrix reads eight rows without bank conflicts.
//   * One warp per 16-row query tile. S = Q K^T by mma.sync.m16n8k16 (bf16
//     in, float32 sums), K through ldmatrix. The scale, bias and mask adds
//     and the softmax run on the accumulator fragments, in float32, as
//     ((s * scale) + bias) + mask, each rounded on its own; row max and sum
//     by quad shuffles. P is rounded to bf16 straight into the A fragments
//     of P V (no trip through shared memory); V comes through
//     ldmatrix.trans. O is summed in float32 and stored as bf16x2; padded
//     query rows are not stored.
//
// float32 (tests and the f32 checks only): the SIMT kernel of the first
// port, since bf16 tensor cores cannot hold float32's 2e-5 tolerance. One
// block per (window, head) copies K and V into shared memory as float32
// (K rows padded to 33 floats); each warp takes query rows in turn, lane l
// keeps the scores of keys l, l + 32, ... in registers, the softmax max and
// sum are warp reductions, and P V broadcasts each p_j by shuffle.
//
// What bounds it: at the main path's shapes (Swin-L, 832x1344, batch 8,
// bf16) a forward moves 7.6 GB through its 24 calls, 2.27 ms at 3.35 TB/s,
// while its 0.54 TFLOP of matrix products would take 0.54 ms on the bf16
// tensor cores: by the card's peaks it is bound by bytes. Inside an SM the
// softmax's exponentials (one MUFU op a score, 16 a clock an SM) and its
// float32 glue cost about as much as the products; the tile design keeps
// both off shared memory and out of the dependent chains of the SIMT
// kernel, which ran a stage-0 call in 7.1 ms against 0.28 ms of bound.
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

// ---- float32: the SIMT kernel ---------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
window_attn_simt_kernel(const float* __restrict__ qkv,   // (nWB, N, 3C)
                        const float* __restrict__ bias,  // (h, N, N)
                        const float* __restrict__ mask,  // (nW, N, N) or null
                        float* __restrict__ out,         // (nWB, N, C)
                        int N, int h, int nW, float scale) {
  __shared__ float ks[kMaxN * kKStride];
  __shared__ float vs[kMaxN * kD];

  const int head = blockIdx.x % h;
  const int64_t w = blockIdx.x / h;
  const int C = h * kD;
  const int64_t row = 3 * (int64_t)C;  // stride of one token in qkv
  const float* win = qkv + w * N * row + head * kD;

  for (int i = threadIdx.x; i < N * kD; i += blockDim.x) {
    const int j = i / kD;
    const int dd = i % kD;
    const float* r = win + j * row + dd;
    ks[j * kKStride + dd] = r[C];
    vs[j * kD + dd] = r[2 * C];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h = bias + (int64_t)head * N * N;
  const float* mask_w = mask == nullptr ? nullptr : mask + (w % nW) * N * N;
  float* out_w = out + w * N * C + head * kD;

  for (int r = warp; r < N; r += kWarps) {
    const float q = win[r * row + lane];
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
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) s[t] /= sum;

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
    out_w[(int64_t)r * C + lane] = acc;
  }
}

cudaError_t launch_simt(const void* qkv, const void* bias, const void* mask, void* out, int nWB,
                        int N, int h, int nW, cudaStream_t stream) {
  const int64_t blocks = (int64_t)nWB * h;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float scale = 1.0f / sqrtf((float)kD);
  window_attn_simt_kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), N, h, nW, scale);
  return cudaGetLastError();
}

// ---- bfloat16: tensor-core tiles ------------------------------------------

constexpr int kWindowsPerBlock = 8;  // windows a block takes when there is no mask
constexpr int kRowBytes = kD * 2;    // a token's bf16 head slice: 4 chunks of 16 bytes
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..3) of row r in a swizzled Q/K/V tile:
// ldmatrix's eight row addresses of one chunk land on eight distinct bank groups
__device__ __forceinline__ int tile_offset(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b for one m16n8k16 tile: bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage an (N, N) float32 tile as an (Np, Np) one in the order of the
// m16n8 accumulator fragments: fragment (row tile rt, key tile nt) is 32
// lanes x 4 floats, lane (g, t) holding rows 16 rt + g, + 8 and keys
// 8 nt + 2t, + 1. Padded keys get `pad_key`, padded rows (real keys) 0.
// The real values come by 4-byte cp.async, all in flight at once (a loop
// of plain loads would wait out one L2 round trip an element a thread),
// into the caller's commit group.
template <int NT>
__device__ void stage_fragments(float* dst, const float* __restrict__ src, int N, float pad_key) {
  constexpr int Np = 16 * NT;
#pragma unroll 4
  for (int i = threadIdx.x; i < Np * Np; i += blockDim.x) {
    const int r = i / Np;
    const int j = i - r * Np;
    const int lane = (r & 7) * 4 + ((j & 7) >> 1);
    const int e = ((r >> 3) & 1) * 2 + (j & 1);
    float* d = dst + (((r >> 4) * (2 * NT) + (j >> 3)) * 32 + lane) * 4 + e;
    if (j < N && r < N)
      cp_async4(d, src + r * N + j);
    else
      *d = j >= N ? pad_key : 0.f;
  }
}

// cp.async copies of window w's Q, K and V head slices into one buffer
// (three (Np, 64-byte) tiles); rows >= N keep the zeros written at start
__device__ __forceinline__ void load_window(char* buf, const __nv_bfloat16* __restrict__ qkv,
                                            int64_t w, int N, int C, int head, int Np) {
  const int64_t row = 3 * (int64_t)C;
  const __nv_bfloat16* win = qkv + w * N * row + head * kD;
  for (int i = threadIdx.x; i < 3 * N * 4; i += blockDim.x) {
    const int part = i / (N * 4);  // 0 q, 1 k, 2 v
    const int r = (i >> 2) - part * N;
    const int c = i & 3;
    cp_async16(buf + part * Np * kRowBytes + tile_offset(r, c), win + r * row + part * C + c * 8);
  }
}

template <int NT>
__global__ void __launch_bounds__(NT * 32, 1)
window_attn_tc_kernel(const __nv_bfloat16* __restrict__ qkv,  // (nWB, N, 3C)
                      const float* __restrict__ bias,          // (h, N, N)
                      const float* __restrict__ mask,          // (nW, N, N) or null
                      __nv_bfloat16* __restrict__ out,         // (nWB, N, C)
                      int nWB, int N, int h, int stride, int stage_mask, float scale) {
  constexpr int Np = 16 * NT;
  constexpr int kTile = Np * kRowBytes;
  extern __shared__ __align__(16) char smem[];
  float* bias_s = reinterpret_cast<float*>(smem);
  float* mask_s = bias_s + Np * Np;
  char* bufs = smem + (size_t)Np * Np * 4 * (stage_mask ? 2 : 1);

  const int head = blockIdx.x % h;
  const int m = blockIdx.x / h;  // first window; with a mask, the mask window too
  const int C = h * kD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // zero both buffers (the padded rows stay zero), then start window m's copy
  for (int i = threadIdx.x; i < 2 * 3 * kTile / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // one commit group: window m's Q, K and V, the bias and the mask
  load_window(bufs, qkv, m, N, C, head, Np);
  stage_fragments<NT>(bias_s, bias + (int64_t)head * N * N, N, -INFINITY);
  const float* mask_m = mask == nullptr ? nullptr : mask + (int64_t)m * N * N;
  if (mask_m != nullptr && stage_mask) stage_fragments<NT>(mask_s, mask_m, N, 0.f);
  cp_async_commit();

  const int r0 = warp * 16 + g;  // this lane's query rows r0 and r0 + 8
  const float4* bias_f = reinterpret_cast<const float4*>(bias_s) + warp * (2 * NT) * 32 + lane;
  const float4* mask_f = reinterpret_cast<const float4*>(mask_s) + warp * (2 * NT) * 32 + lane;

  int it = 0;
  for (int64_t w = m; w < nWB; w += stride, ++it) {
    const char* qs = bufs + (it & 1) * 3 * kTile;
    const char* ks = qs + kTile;
    const char* vs = qs + 2 * kTile;
    if (w + stride < nWB)
      load_window(bufs + ((it + 1) & 1) * 3 * kTile, qkv, w + stride, N, C, head, Np);
    cp_async_commit();  // possibly empty: the wait below always leaves one group
    cp_async_wait_one();
    __syncthreads();

    // Q fragments of this warp's 16 rows, the head dim in two k16 steps
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(qa[kk], qs + tile_offset(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                           2 * kk + (lane >> 4)));

    // S = Q K^T over Np keys, 8 at a time
    float s[2 * NT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + tile_offset(nt * 8 + (lane & 7), lane >> 3));
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      mma_bf16(s[nt], qa[0], kb[0], kb[1]);
      mma_bf16(s[nt], qa[1], kb[2], kb[3]);
    }

    // ((s * scale) + bias) + mask in float32, each rounded on its own
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      const float4 b = bias_f[nt * 32];
      float v[4] = {__fadd_rn(__fmul_rn(s[nt][0], scale), b.x),
                    __fadd_rn(__fmul_rn(s[nt][1], scale), b.y),
                    __fadd_rn(__fmul_rn(s[nt][2], scale), b.z),
                    __fadd_rn(__fmul_rn(s[nt][3], scale), b.w)};
      if (mask_m != nullptr) {
        float mk[4];
        if (stage_mask) {
          const float4 f = mask_f[nt * 32];
          mk[0] = f.x, mk[1] = f.y, mk[2] = f.z, mk[3] = f.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + (e >> 1) * 8;
            const int j = nt * 8 + 2 * t + (e & 1);
            mk[e] = r < N && j < N ? __ldg(mask_m + r * N + j) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(v[e], mk[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = v[e];
      mx0 = fmaxf(mx0, fmaxf(v[0], v[1]));
      mx1 = fmaxf(mx1, fmaxf(v[2], v[3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the quad holds a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum0 += __shfl_xor_sync(kFull, sum0, o);
      sum1 += __shfl_xor_sync(kFull, sum1, o);
    }
    const float inv0 = 1.f / sum0;
    const float inv1 = 1.f / sum1;

    // O = P V: P rounded to bf16 into the A fragments, V by ldmatrix.trans
    float o[4][4];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0),
                              pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1),
                              pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0),
                              pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1)};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + tile_offset(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               2 * half + (lane >> 4)));
        mma_bf16(o[2 * half], pa, vb[0], vb[1]);
        mma_bf16(o[2 * half + 1], pa, vb[2], vb[3]);
      }
    }

    __nv_bfloat16* out_w = out + w * N * C + head * kD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (r0 < N)
        *reinterpret_cast<__nv_bfloat162*>(out_w + (int64_t)r0 * C + dn * 8) =
            __floats2bfloat162_rn(o[dn][0], o[dn][1]);
      if (r0 + 8 < N)
        *reinterpret_cast<__nv_bfloat162*>(out_w + (int64_t)(r0 + 8) * C + dn * 8) =
            __floats2bfloat162_rn(o[dn][2], o[dn][3]);
    }
    __syncthreads();  // this buffer is the copy target of the next iteration but one
  }
}

// shared memory of the tile kernel: the bias fragments, the mask fragments
// when staged, and two buffers of Q, K and V tiles
size_t tc_smem_bytes(int NT, bool stage_mask) {
  const size_t Np = 16 * NT;
  return Np * Np * 4 * (stage_mask ? 2 : 1) + 2 * 3 * Np * kRowBytes;
}

template <int NT>
cudaError_t launch_tc_nt(const void* qkv, const void* bias, const void* mask, void* out, int nWB,
                         int N, int h, int nW, cudaStream_t stream) {
  // the mask is staged where it fits (Np <= 144); at Np = 160 it is read from L2
  const bool stage_mask = mask != nullptr && tc_smem_bytes(NT, true) <= kMaxSmem;
  const size_t smem = tc_smem_bytes(NT, stage_mask);
  const int stride = mask != nullptr ? nW : (nWB + kWindowsPerBlock - 1) / kWindowsPerBlock;
  const int64_t blocks = (int64_t)stride * h;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(window_attn_tc_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attn_tc_kernel<NT><<<(unsigned)blocks, NT * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), nWB, N, h, stride,
      stage_mask ? 1 : 0, 1.0f / sqrtf((float)kD));
  return cudaGetLastError();
}

// builds of the tile kernel by key tiles of 16: 49 tokens take 4, 144 take
// 9, 160 take 10; any other N takes the next larger build
cudaError_t launch_tc(const void* qkv, const void* bias, const void* mask, void* out, int nWB,
                      int N, int h, int nW, cudaStream_t stream) {
  const int nt = (N + 15) / 16;
  if (nt <= 4) return launch_tc_nt<4>(qkv, bias, mask, out, nWB, N, h, nW, stream);
  if (nt <= 9) return launch_tc_nt<9>(qkv, bias, mask, out, nWB, N, h, nW, stream);
  return launch_tc_nt<10>(qkv, bias, mask, out, nWB, N, h, nW, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 qkv/out (the SIMT kernel), 1 = bfloat16 qkv/out (the
// tensor-core tile kernel). bias (h, N, N) and mask (nW, N, N) are float32;
// mask may be null. Head dim 32, 1 <= N <= 160. Returns the CUDA error code
// of the launch (0 on success); the launch does not synchronise.
int window_attn_fwd(const void* qkv, const void* bias, const void* mask, void* out, int dtype,
                    int nWB, int N, int h, int nW, void* stream) {
  if (N < 1 || N > kMaxN || h < 1) return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (nW < 1 || nWB % nW != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_simt(qkv, bias, mask, out, nWB, N, h, nW, s);
  } else if (dtype == 1) {
    err = launch_tc(qkv, bias, mask, out, nWB, N, h, nW, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
