// GQA flash attention in bfloat16 on Hopper's tensor cores, causal or
// bidirectional, forward only (the gradient: flash_attention_bwd.cu).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:74 flash_attention_kernel
// (Pallas body _fa_kernel :28, pallas_call :97) for bfloat16 inputs; the
// float32 route stays on flash_attention.cu.  For q [B, S, H, hd] and
// k, v [B, Skv, Hkv, hd] in bfloat16 (any strides over b, s and h that are
// multiples of 16 bytes, the last axis contiguous, 16-byte-aligned bases),
// query head h reads kv head h / (H / Hkv) and
//   o[b, i, h] = sum_j softmax_j(scale * q_i . k_j) v_j,  scale = 1/sqrt(scale_hd),
// over j <= i when causal (which needs Skv == S) and over all j < Skv
// otherwise (an encoder's memory under cross-attention), written as bfloat16
// into o [B, S, H, hd] (strides given).  Online softmax in float32, in the
// base-2 domain with log2(e) * scale folded into one factor:
//   m' = max(m, c * max_j s_j); alpha = 2^(m - m'); p_j = 2^(c s_j - m')
//   l = l * alpha + sum_j p_j;  acc = acc * alpha + sum_j (big_j + small_j) v_j
// with big_j = bf16(p_j) and small_j = bf16(p_j - big_j), and
// o = acc / max(l, 1e-30).  When the caller asks (a training forward), the
// row's log-sum-exp of the scaled scores, lse = (m + log2 l) ln 2 in
// natural units, goes to a float32 [B, H, S] for the backward: one store
// per row, the arithmetic above unchanged.  Masked scores are -1e30 (the Pallas kernel's
// value).  Every row is computed: a ragged S is masked, not dropped, and
// the keys of the last tile past Skv are masked.
// scale_hd is the head dim before the wrapper zero-padded it to one of the
// instantiated HD (16, 32, 64, 96, 128); zero columns leave q . k as it is.  The
// row sums come from the float32 p.  P enters the bf16 tensor cores as two
// parts because one bf16 rounding (up to 2^-9 of p) is too coarse: an early
// row averages a few v rows whose sum cancels, and its error scales with
// sum_j p_j |v_j|, not with |o|.  With one rounding, the card test at
// llama3-8b's head layout failed the bf16 check (1e-2 |o| + 2e-3) with
// |err| 0.0024 in row 1, which averages two keys (H100 80GB HBM3, 700 W).
// tests/test_torch_flash_numerics.py emulates this arithmetic on the CPU.
//
// Bound on an H100 SXM: operations.  At the llama3-8b prefill shape
// (B=4, S=2048, H=32, Hkv=8, hd=128, causal) the useful work is
// 4*B*H*hd*S*(S+1)/2 = 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 0.050 ms for the 168 MB of q, k, v and o at
// 3.35 TB/s.
//
// Design (simple and right first; warp specialisation, ping-pong between
// the warpgroups and a persistent grid are later work):
// * One CTA of two warpgroups per (b, h, tile of 128 query rows); each
//   warpgroup owns 64 rows.  The CTAs with the most causal work launch
//   first, and the query heads that share a kv head are adjacent in
//   blockIdx, so their K/V tiles come from L2.
// * TMA moves every tile.  q, k and v are each described as a 4-D tensor
//   (hd, H, S, B) with the caller's strides, so strided views such as
//   slices of a fused projection need no copy; the box is (chunk, 1, 128,
//   1) with chunk = hd below 64, 64 for hd = 128 and 32 for hd = 96,
//   written with the swizzle whose width is the box's row (32, 64 or 128
//   bytes); hd = 128 arrives as two 64-column boxes and hd = 96 as three
//   32-column ones.  The Q
//   tile is loaded once; K and V tiles of 128 keys go through a ring of two
//   stages, each completed on its own mbarrier, so S = Q K^T of a tile can
//   start before its V has landed, and the next tile's loads fly while this
//   one is computed.  K and V's tensor maps take Skv as their extent, q's
//   S: TMA zero-fills rows past either, and keys >= Skv are masked.
// * Both products run on wgmma.  S = Q K^T is m64n128k16 with Q and K read
//   K-major from shared memory.  O += P V is m64n{hd}k16, twice per k16
//   step (big, then small), with P from registers: the float32 accumulator
//   fragment of S, packed as bf16 pairs, is the A-operand fragment, so P
//   never touches shared memory; V is read MN-major straight from its
//   [keys, hd] tile (trans-b), with no transpose.  The tensor cores thus do
//   1.5x the function's operations.
// * The softmax stays in registers: each row lives on the four threads of a
//   quad, so a row max costs two shuffles per tile; the row sums are kept
//   per thread and reduced once at the end.  Only the diagonal tile of a
//   causal CTA and the last tile of a ragged Skv are masked; tiles above
//   the diagonal are not visited.
//
// Measured by chip_smoke.py (phases 2 and 9) on an H100 80GB HBM3 at
// 700 W: 0.414-0.420 ms per call at the llama3-8b shape above, 327-332
// TFLOP/s of the function's operations, against 0.252-0.256 ms for
// PyTorch's SDPA; 162-231 registers per thread, no spills.  What limits it
// now (an inference from these times, not profiled): the two warpgroups
// wait on the same tiles and run their softmax and their products in step,
// so the tensor cores idle during the softmax; ping-pong is the lever.
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;
constexpr int kWgRows = 64;                         // query rows per warpgroup
constexpr int kQTile = kWarpgroups * kWgRows;       // query rows per CTA
constexpr int kKTile = 128;                         // keys per K/V tile
constexpr int kStages = 2;                          // K/V ring depth
constexpr int kBoxRows = 128;                       // TMA box rows (q and kv tiles)
constexpr float kNegInf = -1e30f;                   // the Pallas kernel's mask value
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQTile == kBoxRows && kKTile == kBoxRows, "one TMA box shape for all tiles");

struct Strides {
  int64_t b, s, h;                                  // element strides; last axis is 1
};

// Shared-memory geometry for head dim HD: tiles are stored as TMA writes
// them, in column chunks of kChunk (the swizzle width), each chunk
// [128 rows][kChunk] with rows of kRowBytes.  96 is no multiple of 64, so
// it takes three chunks of 32 (64-byte swizzle), as hd 32 takes one.
template <int HD>
struct Geometry {
  static constexpr int kChunk = HD < 64 ? HD : HD % 64 == 0 ? 64 : 32;
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kRowBytes = kChunk * 2;
  static constexpr int kKPerChunk = kChunk / 16;    // k16 steps within one chunk
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kChunkBytes = kBoxRows * kRowBytes;
  static constexpr int kTileBytes = kChunks * kChunkBytes;
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kTileBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  static constexpr int kBars = 1 + 3 * kStages;     // q, k[], v[], empty[]
  static constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;  // + alignment slack
  static_assert(HD % 16 == 0 && HD <= 128 && HD % kChunk == 0, "head dim");
};

__device__ __forceinline__ uint32_t bar_k(uint32_t bars, int s) { return bars + 8 * (1 + s); }
__device__ __forceinline__ uint32_t bar_v(uint32_t bars, int s) {
  return bars + 8 * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t bar_free(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * kStages + s);
}

// one thread: TMA loads of the K and V tiles of keys [key0, key0 + 128)
// into ring stage s, each completed on its own barrier
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t sK, uint32_t sV, uint32_t bars, int s,
                                        int key0, int hk, int b) {
  using G = Geometry<HD>;
  sm90::mbar_expect_tx(bar_k(bars, s), G::kTileBytes);
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    sm90::tma_load_4d(sK + s * G::kTileBytes + c * G::kChunkBytes, tk, bar_k(bars, s),
                      c * G::kChunk, hk, key0, b);
  sm90::mbar_expect_tx(bar_v(bars, s), G::kTileBytes);
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c)
    sm90::tma_load_4d(sV + s * G::kTileBytes + c * G::kChunkBytes, tv, bar_v(bars, s),
                      c * G::kChunk, hk, key0, b);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                            Strides so, int S, int Skv, int H, int group, int BH,
                            float scale_log2) {
  using G = Geometry<HD>;
  constexpr int kSRegs = kKTile / 2;                // S accumulator: 64 floats per thread
  constexpr int kORegs = HD / 2;                    // O accumulator
  constexpr int kPSteps = kKTile / 16;              // k16 steps of P.V
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + G::kQOff, sK = base + G::kKOff, sV = base + G::kVOff;
  const uint32_t bars = base + G::kBarOff;          // bars + 0 is the Q barrier

  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / group;
  const int q0 = qt * kQTile;
  const int k_end = CAUSAL ? min(S, q0 + kQTile) : Skv;
  const int n_tiles = (k_end + kKTile - 1) / kKTile;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;
  // accumulator fragment: this thread holds rows r and r + 8 of its
  // warpgroup's 64, and in each 8-column group columns 2 * (lane % 4) + {0, 1}
  const int row0 = q0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);

  if (tid == 0) {
    sm90::prefetch_tmap(&tq);
    sm90::prefetch_tmap(&tk);
    sm90::prefetch_tmap(&tv);
    sm90::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(bar_k(bars, s), 1);
      sm90::mbar_init(bar_v(bars, s), 1);
      sm90::mbar_init(bar_free(bars, s), kThreads / 32);   // one arrival per warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bars, G::kTileBytes);
#pragma unroll
    for (int c = 0; c < G::kChunks; ++c)
      sm90::tma_load_4d(sQ + c * G::kChunkBytes, &tq, bars, c * G::kChunk, h, q0, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      load_kv<HD>(&tk, &tv, sK, sV, bars, t, t * kKTile, hk, b);
  }
  __syncwarp();

  float acc[kORegs];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};                  // running max, scaled (base 2)
  float l[2] = {0.f, 0.f};                          // this thread's part of the row sum

  // Q descriptors' base for this warpgroup's 64 rows (K-major, no LBO)
  const uint32_t q_rows = sQ + wg * kWgRows * G::kRowBytes;
  sm90::mbar_wait(bars, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int key0 = t * kKTile;
    const uint32_t k_tile = sK + s * G::kTileBytes;
    const uint32_t v_tile = sV + s * G::kTileBytes;

    // S = Q K^T on the tensor cores
    float sc[kSRegs];
    sm90::mbar_wait(bar_k(bars, s), parity);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk / G::kKPerChunk) * G::kChunkBytes + (kk % G::kKPerChunk) * 32;
      const uint64_t da = sm90::make_desc(q_rows + koff, 16, 8 * G::kRowBytes, G::kSwizzle);
      const uint64_t db = sm90::make_desc(k_tile + koff, 16, 8 * G::kRowBytes, G::kSwizzle);
      sm90::wgmma_ss_n128(sc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // mask: the diagonal tile of a causal CTA, and keys past a ragged Skv
    if (key0 + kKTile > Skv || (CAUSAL && key0 + kKTile > q0)) {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (key >= Skv || (CAUSAL && key > row)) sc[i] = kNegInf;
      }
    }

    // online softmax: row r uses sc[4j + {0, 1}], row r + 8 sc[4j + {2, 3}]
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSRegs / 4; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hh], mx * scale_log2);
      alpha[hh] = sm90::exp2_approx(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSRegs / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hh + e];
          x = sm90::exp2_approx(fmaf(x, scale_log2, -m_new));
          sum += x;
        }
      }
      l[hh] = l[hh] * alpha[hh] + sum;
    }
#pragma unroll
    for (int i = 0; i < kORegs; ++i) acc[i] *= alpha[(i / 2) % 2];

    // P = P_big + P_small as bf16 A fragments: k16 step kk holds keys
    // [16 kk, 16 kk + 16)
    uint32_t p_big[kPSteps][4], p_small[kPSteps][4];
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sm90::split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_big[kk][r],
                         p_small[kk][r]);
      sm90::fence_regs(p_big[kk]);
      sm90::fence_regs(p_small[kk]);
    }
    sm90::fence_regs(acc);

    // O += P V on the tensor cores, V MN-major from its [keys, hd] tile
    sm90::mbar_wait(bar_v(bars, s), parity);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint64_t dv = sm90::make_desc(v_tile + kk * 16 * G::kRowBytes, G::kChunkBytes,
                                          8 * G::kRowBytes, G::kSwizzle);
      sm90::wgmma_rs<HD>(acc, p_big[kk], dv, 1);
      sm90::wgmma_rs<HD>(acc, p_small[kk], dv, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    // release the stage; thread 0 refills it with tile t + kStages
    if (lane == 0) sm90::mbar_arrive(bar_free(bars, s));
    if (tid == 0 && t + kStages < n_tiles) {
      sm90::mbar_wait(bar_free(bars, s), parity);
      load_kv<HD>(&tk, &tv, sK, sV, bars, s, (t + kStages) * kKTile, hk, b);
    }
    __syncwarp();
  }

  // o = acc / max(l, 1e-30), rows < S only
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
  }
  const int64_t obase = b * so.b + h * so.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= S) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * S + row] = (m[hh] + log2f(l[hh])) * 0.6931471805599453f;
    __nv_bfloat16* orow = o + obase + row * so.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint32_t v2 = sm90::pack_bf16(acc[4 * j + 2 * hh] / denom,
                                          acc[4 * j + 2 * hh + 1] / denom);
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) = v2;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that this shared
// library needs no link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, n_heads, S, B) with the caller's strides; box (chunk, 1, 128, 1)
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, const Strides& st, int B, int S, int n_heads) {
  using G = Geometry<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {G::kChunk, 1, kBoxRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st, int B, int S, int Skv, int H, int Hkv, int scale_hd,
                   cudaStream_t stream) {
  using G = Geometry<HD>;
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(&tq, q, st[0], B, S, H) || !encode<HD>(&tk, k, st[1], B, Skv, Hkv) ||
      !encode<HD>(&tv, v, st[2], B, Skv, Hkv))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_sm90_kernel<HD, CAUSAL>;
  static bool configured = false;                   // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int BH = B * H;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(scale_hd));
  kernel<<<static_cast<unsigned>(BH) * n_qtiles, kThreads, G::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, st[3], S, Skv, H, H / Hkv, BH,
      scale_log2);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Strides* st, int B, int S, int Skv, int H, int Hkv,
                        int hd, int scale_hd, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    case 32:
      return launch<32, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    case 64:
      return launch<64, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    case 96:
      return launch<96, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    case 128:
      return launch<128, CAUSAL>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, scale_hd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// flash_attention.cu's CUDA-core kernel on bfloat16, for hd 192, 256 and
// above 256.
extern "C" int flash_attention_fwd_cc_bf16(const void* q, const void* k, const void* v,
                                           void* o, float* lse, int causal, int B, int S,
                                           int Skv, int H, int Hkv, int hd, int scale_hd,
                                           const int64_t* strides, cudaStream_t stream);

// Launches the bfloat16 kernel on `stream` and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue when a tensor map cannot be
// encoded).  lse: nullptr, or a float32 [B, H, S] that receives each row's
// log-sum-exp of the scaled scores in natural units (for the backward).  Skv >= 1 is k's and v's length, S's own when causal.  hd is
// an instantiated head dim, scale_hd in [1, hd] the one whose 1/sqrt
// scales the scores.  strides: 12 element strides, (b, s, h)
// of q, k, v and o in that order.  S == 0 launches nothing.  hd 192, 256 and
// any hd above 256 go to flash_attention_fwd_cc_bf16 (CUDA cores, plain
// strided loads): the wgmma kernel's tiles stop at 128.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int causal, int B, int S, int Skv, int H,
                                        int Hkv, int hd, int scale_hd, const int64_t* strides,
                                        cudaStream_t stream) {
  if (hd > 128)
    return flash_attention_fwd_cc_bf16(q, k, v, o, lse, causal, B, S, Skv, H, Hkv, hd,
                                       scale_hd, strides, stream);
  if (S == 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (Skv < 1 || (causal && Skv != S) || Hkv <= 0 || H % Hkv != 0 || scale_hd < 1 ||
      scale_hd > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaError_t err =
      causal ? dispatch_hd<true>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, hd, scale_hd, stream)
             : dispatch_hd<false>(q, k, v, o, lse, st, B, S, Skv, H, Hkv, hd, scale_hd,
                                  stream);
  return static_cast<int>(err);
}
