// GQA flash attention in float32, causal or bidirectional, forward only
// (the gradient: flash_attention_bwd.cu).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:74 flash_attention_kernel
// (Pallas body _fa_kernel, layout wrapper ops.flash_attention) for float32
// inputs; bfloat16 inputs go to flash_attention_sm90.cu, which hands the
// head dims its tensor-core kernel lacks (above 128) to this kernel's
// bfloat16 instantiation (flash_attention_fwd_cc_bf16: bfloat16 loads and
// stores, float32 math).  For q [B, S, H, hd]
// and k, v [B, Skv, Hkv, hd] (any strides over b, s and h, the
// last axis contiguous), query head h reads kv head h / (H / Hkv) and
//   o[b, i, h] = sum_j softmax_j(scale * q_i . k_j) v_j,  scale = 1/sqrt(scale_hd),
// over j <= i when causal (which needs Skv == S) and over all j < Skv
// otherwise (an encoder's memory under cross-attention), written into a
// contiguous o [B, S, H, hd].  hd is one of the instantiations (16, 32, 64,
// 96, 128, 192, 256 in float32; 192, 256 in bfloat16) or any hd above 256
// (the wide form below, both types); scale_hd is the head dim before the
// wrapper zero-padded it.  The math is full float32, with the
// reference's online softmax: per tile of keys
//   m_cur = max(m, max_j s_j); alpha = exp(m - m_cur); p_j = exp(s_j - m_cur)
//   l = l * alpha + sum_j p_j;  acc = acc * alpha + sum_j p_j v_j;  m = m_cur
// and o = acc / max(l, 1e-30); when the caller asks (a training forward),
// each row's log-sum-exp m + log l (natural units) goes to a float32
// [B, H, S] for the backward.  Masked scores are -1e30, as in the Pallas
// kernel.  Every row is computed: a ragged S is masked here, not dropped,
// and so is the tail of the last key tile past Skv.
//
// Bound on an H100: operations.  At the llama3-8b prefill head layout
// (B=4, S=2048, H=32, Hkv=8, hd=128, causal) the useful work is
// 4*B*H*S^2*hd/2 = 137 GFLOP, 2.05 ms at the 67 TFLOP/s float32 rate of
// the CUDA cores (the route must stay full float32, so TF32 and bf16
// tensor cores are out).
//
// Design: one CTA of 8 warps per (b, h, tile of 64 query rows), each warp
// owning 8 rows.  The CTA stages its q tile and, 32 keys at a time, a K and
// a V tile in shared memory, shared by all 8 warps.  Scores put a key on
// each lane: lane j forms q_r . k_j for the warp's 8 rows with 16-byte
// loads (the q reads are broadcasts; the K rows are padded by 4 floats so
// the lanes' 16-byte reads fall in distinct banks), so no shuffle
// reduction is needed per score.  The softmax reduces each row's 32 scores
// with 5 shuffles; P.V broadcasts p_j by shuffle while each lane owns hd/32
// output columns.  Causal tiles above the diagonal are not visited, a warp
// skips a tile that its rows cannot see, and the CTAs with the most causal
// work are launched first.  At hd 256 the tiles take (64*256 + 32*260 +
// 32*256) * 4 B = 131.6 kB of shared memory (one CTA an SM) and a lane
// holds 8 rows x 8 output columns of accumulator.
//
// Above hd 256 that layout outgrows the card (at hd 512: 262.7 kB of tiles,
// 8 x 16 accumulators a lane), so the wide form keeps shared memory and
// registers independent of hd.  The same CTA of 8 warps walks the output
// columns in slices of 256 (8 a lane, as at hd 256); for each slice it
// walks the keys in tiles of 32, and for each key tile forms the scores
// over hd in chunks of 64 columns of q and k staged in shared memory,
// recomputes the running max and sum (the same values for every slice:
// the same scores in the same order), and adds P times the tile's V
// columns of the slice.  Tiles: (64*64 + 32*68 + 32*256) * 4 B = 57.9 kB.
// It recomputes QK^T once per slice: at hd 512 the products are 1.5x the
// function's.  A simple form, not yet a fast one.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                    // query rows per warp
constexpr int kQTile = kWarps * kRows;      // query rows per CTA
constexpr int kKTile = 32;                  // keys per tile: one per lane
constexpr float kNegInf = -1e30f;           // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;                          // element strides; last axis is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);               // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  return kQTile * HD + kKTile * (HD + 4) + kKTile * HD;
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int S, int Skv, int H, int group, int BH, float scale) {
  constexpr int KS = HD + 4;                // padded row of the K tile
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kQTile][HD]
  float* Ks = Qs + kQTile * HD;                  // [kKTile][KS]
  float* Vs = Ks + kKTile * KS;                  // [kKTile][HD]

  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = qt * kQTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRows;       // this warp's first query row

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int i = threadIdx.x; i < kQTile * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    Qs[i] = row < S ? to_f32(qb[row * sq.s + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int k_end = CAUSAL ? min(S, q0 + kQTile) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kKTile) {
    __syncthreads();                        // the last tile's readers are done
    for (int i = threadIdx.x; i < kKTile * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      Ks[j * KS + d] = key < Skv ? to_f32(kb[key * sk.s + d]) : 0.f;
      Vs[i] = key < Skv ? to_f32(vb[key * sv.s + d]) : 0.f;
    }
    __syncthreads();
    if (row0 >= S || (CAUSAL && row0 + kRows - 1 < k0)) continue;

    // scores: lane j holds key k0 + j for each of the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KS;
    const float* qrows = Qs + warp * kRows * HD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qrows + r * HD + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int key = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool valid = key < Skv && (!CAUSAL || key <= row0 + r);
      const float sr = valid ? s[r] * scale : kNegInf;
      const float m_cur = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_cur);
      p[r] = expf(sr - m_cur);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }

    // acc += P V: lane owns columns lane + 32c
#pragma unroll 4
    for (int j = 0; j < kKTile; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < HD ? Vs[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= S) break;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[static_cast<int64_t>(bh) * S + row] = m[r] + logf(l[r]);
    T* orow = o + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) orow[d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

constexpr int kWideChunk = 64;              // q, k columns staged per pass
constexpr int kWideSlice = 256;             // output columns per slice
constexpr int kWideDPL = kWideSlice / 32;   // output columns per lane
constexpr int kWideSmemFloats =
    kQTile * kWideChunk + kKTile * (kWideChunk + 4) + kKTile * kWideSlice;

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                            Strides so,
                            int S, int Skv, int H, int group, int BH, int HD,
                            float scale) {
  constexpr int KS = kWideChunk + 4;        // padded row of the K chunk
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kQTile][kWideChunk]
  float* Ks = Qs + kQTile * kWideChunk;          // [kKTile][KS]
  float* Vs = Ks + kKTile * KS;                   // [kKTile][kWideSlice]

  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = qt * kQTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRows;       // this warp's first query row

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int k_end = CAUSAL ? min(S, q0 + kQTile) : Skv;

  for (int c0 = 0; c0 < HD; c0 += kWideSlice) {
    float m[kRows], l[kRows], acc[kRows][kWideDPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kWideDPL; ++c) acc[r][c] = 0.f;
    }

    for (int k0 = 0; k0 < k_end; k0 += kKTile) {
      // warp-uniform: whether any of this warp's rows sees this key tile
      const bool live = row0 < S && !(CAUSAL && row0 + kRows - 1 < k0);

      // scores over hd, kWideChunk columns of q and k at a time
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      for (int d0 = 0; d0 < HD; d0 += kWideChunk) {
        __syncthreads();                    // the last chunk's readers are done
        for (int i = threadIdx.x; i < kQTile * kWideChunk; i += blockDim.x) {
          const int r = i / kWideChunk, d = d0 + i % kWideChunk, row = q0 + r;
          Qs[i] = row < S && d < HD ? to_f32(qb[row * sq.s + d]) : 0.f;
        }
        for (int i = threadIdx.x; i < kKTile * kWideChunk; i += blockDim.x) {
          const int j = i / kWideChunk, dc = i % kWideChunk, d = d0 + dc, key = k0 + j;
          Ks[j * KS + dc] = key < Skv && d < HD ? to_f32(kb[key * sk.s + d]) : 0.f;
        }
        __syncthreads();
        if (!live) continue;
        const float* krow = Ks + lane * KS;
        const float* qrows = Qs + warp * kRows * kWideChunk;
#pragma unroll 4
        for (int d = 0; d < kWideChunk; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 qq =
                *reinterpret_cast<const float4*>(qrows + r * kWideChunk + d);
            s[r] = fmaf(qq.x, kk.x, s[r]);
            s[r] = fmaf(qq.y, kk.y, s[r]);
            s[r] = fmaf(qq.z, kk.z, s[r]);
            s[r] = fmaf(qq.w, kk.w, s[r]);
          }
        }
      }

      // this slice's columns of the tile's V rows
      __syncthreads();                      // the last tile's P.V readers are done
      for (int i = threadIdx.x; i < kKTile * kWideSlice; i += blockDim.x) {
        const int j = i / kWideSlice, d = c0 + i % kWideSlice, key = k0 + j;
        Vs[i] = key < Skv && d < HD ? to_f32(vb[key * sv.s + d]) : 0.f;
      }
      __syncthreads();
      if (!live) continue;

      const int key = k0 + lane;
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = key < Skv && (!CAUSAL || key <= row0 + r);
        const float sr = valid ? s[r] * scale : kNegInf;
        const float m_cur = fmaxf(m[r], warp_max(sr));
        const float alpha = expf(m[r] - m_cur);
        p[r] = expf(sr - m_cur);
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_cur;
#pragma unroll
        for (int c = 0; c < kWideDPL; ++c) acc[r][c] *= alpha;
      }

      // acc += P V over the slice: lane owns columns c0 + lane + 32c
#pragma unroll 4
      for (int j = 0; j < kKTile; ++j) {
        float vv[kWideDPL];
#pragma unroll
        for (int c = 0; c < kWideDPL; ++c) vv[c] = Vs[j * kWideSlice + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
          for (int c = 0; c < kWideDPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= S) break;
      const float denom = fmaxf(l[r], 1e-30f);
      if (lse != nullptr && c0 == 0 && lane == 0)
        lse[static_cast<int64_t>(bh) * S + row] = m[r] + logf(l[r]);
      T* orow = o + b * so.b + row * so.s + h * so.h;
#pragma unroll
      for (int c = 0; c < kWideDPL; ++c) {
        const int d = c0 + lane + 32 * c;
        if (d < HD) orow[d] = from_f32<T>(acc[r][c] / denom);
      }
    }
  }
}

template <typename T, bool CAUSAL>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Strides* st, int B, int S, int Skv, int H, int Hkv,
                        int hd, int scale_hd, cudaStream_t stream) {
  constexpr size_t smem = kWideSmemFloats * sizeof(float);
  auto kernel = flash_attention_wide_kernel<T, CAUSAL>;
  static bool configured = false;           // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const float scale = 1.0f / sqrtf(static_cast<float>(scale_hd));
  kernel<<<static_cast<unsigned>(BH) * n_qtiles, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], S, Skv, H, H / Hkv, BH, hd,
      scale);
  return cudaGetLastError();
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st, int B, int S, int Skv, int H, int Hkv,
                   int scale_hd, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD, CAUSAL>;
  static bool configured = false;           // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const float scale = 1.0f / sqrtf(static_cast<float>(scale_hd));
  kernel<<<static_cast<unsigned>(BH) * n_qtiles, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], S, Skv, H, H / Hkv, BH, scale);
  return cudaGetLastError();
}

// float32 takes every instantiated head dim; bfloat16 only those above the
// tensor-core kernel's 128.  Any hd above 256 takes the wide form.
template <typename T, bool CAUSAL>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Strides* st, int B, int S, int Skv, int H, int Hkv,
                        int hd, int scale_hd, cudaStream_t stream) {
  if (hd > 256)
    return launch_wide<T, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, hd, scale_hd,
                                  stream);
  switch (hd) {
    case 192: return launch<T, 192, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    case 256: return launch<T, 256, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    default: break;
  }
  if constexpr (std::is_same_v<T, float>) {
    switch (hd) {
      case 16: return launch<T, 16, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
      case 32: return launch<T, 32, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
      case 64: return launch<T, 64, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
      case 96: return launch<T, 96, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
      case 128: return launch<T, 128, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int entry(const void* q, const void* k, const void* v, void* o, float* lse, int causal, int B,
          int S, int Skv, int H, int Hkv, int hd, int scale_hd, const int64_t* strides,
          cudaStream_t stream) {
  if (S == 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (Skv < 1 || (causal && Skv != S) || Hkv <= 0 || H % Hkv != 0 || scale_hd < 1 ||
      scale_hd > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaError_t err =
      causal ? dispatch_hd<T, true>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, hd, scale_hd,
                                    stream)
             : dispatch_hd<T, false>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, hd, scale_hd,
                                     stream);
  return static_cast<int>(err);
}

}  // namespace

// Launches the float32 kernel on `stream` and returns cudaGetLastError()
// (0 on success).  Skv >= 1 is k's and v's length, S's own when causal.  hd
// is an instantiated head dim or above 256, scale_hd in [1, hd] the
// one whose 1/sqrt scales the scores (the head dim before the wrapper
// zero-padded it).  strides: 12 element strides, (b, s, h) of q, k, v and
// o in that order.  lse: nullptr, or a float32 [B, H, S] that receives each
// row's log-sum-exp of the scaled scores (natural units).  S == 0 launches
// nothing.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, float* lse, int causal, int B, int S,
                                       int Skv, int H, int Hkv, int hd, int scale_hd,
                                       const int64_t* strides, cudaStream_t stream) {
  return entry<float>(q, k, v, o, lse, causal, B, S, Skv, H, Hkv, hd, scale_hd, strides,
                      stream);
}

// The same kernel on bfloat16 q, k, v and o, for hd 192, 256 and above 256
// (the head dims above flash_attention_sm90.cu's 128): loads and stores in bfloat16,
// the math in float32.  flash_attention_fwd_bf16 calls it; it reads plain
// strided memory, so no TMA alignment applies.
extern "C" int flash_attention_fwd_cc_bf16(const void* q, const void* k, const void* v,
                                           void* o, float* lse, int causal, int B, int S,
                                           int Skv, int H, int Hkv, int hd, int scale_hd,
                                           const int64_t* strides, cudaStream_t stream) {
  return entry<__nv_bfloat16>(q, k, v, o, lse, causal, B, S, Skv, H, Hkv, hd, scale_hd,
                              strides, stream);
}
