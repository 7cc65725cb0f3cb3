// The gradient of GQA flash attention: dq, dk, dv from q, k, v, the
// forward's row log-sum-exp, and the output gradient dO.
//
// Replaces no Pallas kernel: the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:74 has no backward, and the
// reference trains through XLA's autodiff of its pure-JAX attention (its
// oracle, ref.py::attention_ref, has no custom_vjp).  This file gives the
// port's FlashAttentionFn a hand-written backward in place of the plain
// float32 recompute it had.  The gradient is jax.grad of attention_ref:
// with scale = 1/sqrt(scale_hd), s = scale q k^T (masked j > i when
// causal), P = softmax(s),
//   dV = P^T dO,  dP = dO V^T,  D_i = sum_j P_ij dP_ij,
//   dS = P o (dP - D),  dQ = scale dS K,  dK = scale dS^T Q,
// the query heads of a kv head summed into its dK and dV.  P is rebuilt
// from the forward's log-sum-exp (natural units, float32 [B, H, S]):
// P = 2^(c s_raw - lse log2 e) with c = log2(e) scale, so no second
// softmax runs.  FlashAttention-2's algorithm in two launches:
// * dQ: one CTA per (b, q head, tile of queries), over its key tiles
//   twice.  The first pass forms S, P and dP and sums D_i = sum_j P_ij
//   dP_ij in float32, written to a [B, H, S] workspace; the second forms
//   them again, then dS, and accumulates dQ += dS K.
// * dK/dV: one CTA per (b, kv head, tile of keys).  It loops over the
//   G = H / Hkv query heads that read its kv head and over their query
//   tiles, skipping the tiles above a causal diagonal; it recomputes S and
//   P, accumulates dV += P^T dO, forms dP and dS (D from the workspace),
//   and accumulates dK += dS^T Q.  The accumulators stay in registers and
//   are written once, so the GQA sum happens inside the CTA.
// D is the row's sum_d dO_id o_id, which FlashAttention-2 takes from the
// saved output.  The bf16 output is rounded (2^-9), and D read from it
// put dq and dk at 2.9x the card bound (1e-2 |x| + 2e-3) from the
// reference's gradient at llama3-8b's head layout in the CPU emulation
// (tests/test_torch_flash_backward.py); summed from P and dP in float32
// they are at 0.34x.  That first pass is the price: with no atomicAdd
// anywhere, every output element is summed by one thread in a fixed
// order, so a run is bit for bit the run before it (the meshed train
// steps are held to the unmeshed ones bit for bit), and the separate dQ
// kernel recomputes S and dP.  The products do 18 hd FLOP a computed
// score (QK^T, dO V^T twice and dS K in dQ; QK^T, dO V^T, P^T dO, dS^T Q
// in dK/dV) against the 10 hd of useful work (QK^T, dO V^T, P^T dO,
// dS^T Q, dS K).  Masked scores are excluded (P = 0, the Pallas kernel's
// -1e30 after the exponential), a ragged S is masked rather than dropped,
// and a non-causal call takes k, v of a length Skv of their own.
//
// Two routes, chosen by dtype and head dim as the forward's are:
//
// bf16, hd <= 128 (16, 32, 64, 96, 128; the wrapper zero-pads other head
// dims): tensor cores, mma.sync.m16n8k16 bf16 -> f32, fragments loaded by
// ldmatrix from padded shared-memory rows (hd + 8 elements, so the eight
// rows of an 8x8 matrix fall in distinct banks), tiles streamed by
// cp.async (16 B a copy: bases and b/s/h strides 16-byte multiples, which
// the wrapper stages as the forward does).  Tiles of 64 keys by 64
// queries, 4 warps of 16 rows each.  dK/dV keeps its K and V tile in
// shared memory and double-buffers Q, dO, lse and D; dQ keeps its Q and dO
// tile and double-buffers K and V through both passes.  S^T = K Q^T (keys
// are the rows, so the row sums of dV and dK stay within a thread's
// fragment) and dP^T = V dO^T are read from the accumulator layout; P^T
// and dS^T enter the next products straight from registers as A
// fragments.  P and dS enter the bf16 tensor cores as two parts,
// big = bf16(x) and small = bf16(x - big): one rounding (2^-9 of x)
// failed the card bound in the CPU emulation (worst |err| / bound 0.97
// for dq, 2.37 dk, 3.27 dv against the exact gradient; 0.33-0.35 with
// both split).  The tensor cores so do 24 hd FLOP a computed score, 2.4
// times the useful work.
//
// float32 at every hd, and bf16 above 128: the same algorithm on the CUDA
// cores in float32 math, with bf16 loads and stores for bf16.  Tiles of 32
// keys by 32 queries, 8 warps; scores summed over hd in chunks of 32
// columns staged in shared memory, and each CTA owns a slice of 64 output
// columns (hd > 64 runs several CTAs per tile, each recomputing S and dP;
// the first slice's CTA writes D), so shared memory (41.5 kB) does not
// grow with hd.  Slow and simple.
//
// Bound on an H100 SXM: operations.  At llama3-8b's training microbatch
// (B = 2, S = 2048, H = 32, Hkv = 8, hd = 128, causal) the useful work is
// 10 hd B H S(S+1)/2 = 172 GFLOP, 0.174 ms at 989 TFLOP/s, against 0.040 ms
// for the 134 MB of q, k, v, dO, lse read and dq, dk, dv written.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;                          // element strides; last axis is 1
};

// element strides of q, k, v, dO, dq, dk, dv
struct BwdStrides {
  Strides q, k, v, dout, dq, dk, dv;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);               // round to nearest even
}

// ---------------------------------------------------------------------------
// CUDA-core route: float32 math, any hd
// ---------------------------------------------------------------------------
constexpr int kCcWarps = 8;
constexpr int kCcThreads = kCcWarps * 32;
constexpr int kCcTile = 32;                 // query rows and keys of a tile
constexpr int kCcRows = kCcTile / kCcWarps; // a warp's rows: 4
constexpr int kCcChunk = 32;                // hd columns a score pass stages
constexpr int kCcSlice = 64;                // output columns a CTA owns
constexpr int kCcCols = kCcSlice / 32;      // of them, a lane's: 2

struct CcTiles {
  float q[kCcTile][kCcChunk], dout[kCcTile][kCcChunk];
  float k[kCcTile][kCcChunk + 1], v[kCcTile][kCcChunk + 1];
};

// s[r] = q_row . k_key and dp[r] = dO_row . v_key over all HD, for this
// warp's rows q0 + 4 warp + r and the key k0 + lane; rows and keys past
// S and Skv read zeros.  Starts with a barrier, so the caller may reuse
// the tiles right after its last read of them.
template <typename T>
__device__ __forceinline__ void cc_scores(CcTiles& t, const T* qb, const T* db, const T* kb,
                                          const T* vb, int64_t qs, int64_t ds, int64_t ks,
                                          int64_t vs, int q0, int k0, int S, int Skv, int HD,
                                          float (&s)[kCcRows], float (&dp)[kCcRows]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kCcRows; ++r) s[r] = dp[r] = 0.f;
  for (int d0 = 0; d0 < HD; d0 += kCcChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kCcTile * kCcChunk; i += kCcThreads) {
      const int r = i / kCcChunk, dc = i % kCcChunk, d = d0 + dc;
      const int row = q0 + r, key = k0 + r;
      const bool qok = row < S && d < HD, kok = key < Skv && d < HD;
      t.q[r][dc] = qok ? to_f32(qb[row * qs + d]) : 0.f;
      t.dout[r][dc] = qok ? to_f32(db[row * ds + d]) : 0.f;
      t.k[r][dc] = kok ? to_f32(kb[key * ks + d]) : 0.f;
      t.v[r][dc] = kok ? to_f32(vb[key * vs + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dc = 0; dc < kCcChunk; ++dc) {
      const float kk = t.k[lane][dc], vv = t.v[lane][dc];
#pragma unroll
      for (int r = 0; r < kCcRows; ++r) {
        s[r] = fmaf(t.q[kCcRows * warp + r][dc], kk, s[r]);
        dp[r] = fmaf(t.dout[kCcRows * warp + r][dc], vv, dp[r]);
      }
    }
  }
}

// one CTA per (slice of 64 output columns, tile of 32 keys, b, kv head)
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kCcThreads)
flash_bwd_dkdv_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ D,
                         T* __restrict__ dk, T* __restrict__ dv, BwdStrides st, int S,
                         int Skv, int H, int Hkv, int HD, float scale) {
  __shared__ CcTiles t;
  __shared__ float P[kCcTile][kCcTile + 1], dS[kCcTile][kCcTile + 1];
  __shared__ float Qs[kCcTile][kCcSlice], dOs[kCcTile][kCcSlice];
  const int n_sl = (HD + kCcSlice - 1) / kCcSlice;
  const int n_kt = (Skv + kCcTile - 1) / kCcTile;
  int idx = static_cast<int>(blockIdx.x);
  const int sl = idx % n_sl;
  idx /= n_sl;
  const int kt = idx % n_kt, bh = idx / n_kt;
  const int b = bh / Hkv, hk = bh % Hkv, group = H / Hkv;
  const int k0 = kt * kCcTile, c0 = sl * kCcSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + b * st.k.b + hk * st.k.h;
  const T* vb = v + b * st.v.b + hk * st.v.h;

  float dka[kCcRows][kCcCols], dva[kCcRows][kCcCols];
#pragma unroll
  for (int j = 0; j < kCcRows; ++j)
#pragma unroll
    for (int c = 0; c < kCcCols; ++c) dka[j][c] = dva[j][c] = 0.f;

  const int n_qt = (S + kCcTile - 1) / kCcTile;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st.q.b + h * st.q.h;
    const T* db = dout + b * st.dout.b + h * st.dout.h;
    const float* lrow = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* drow = D + (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = CAUSAL ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kCcTile;
      float s[kCcRows], dp[kCcRows];
      cc_scores(t, qb, db, kb, vb, st.q.s, st.dout.s, st.k.s, st.v.s, q0, k0, S, Skv, HD,
                s, dp);
      const int key = k0 + lane;
#pragma unroll
      for (int r = 0; r < kCcRows; ++r) {
        const int row = q0 + kCcRows * warp + r;
        const bool ok = row < S && key < Skv && (!CAUSAL || key <= row);
        const float p = ok ? expf(fmaf(s[r], scale, -lrow[row])) : 0.f;
        P[kCcRows * warp + r][lane] = p;
        dS[kCcRows * warp + r][lane] = ok ? p * (dp[r] - drow[row]) : 0.f;
      }
      for (int i = threadIdx.x; i < kCcTile * kCcSlice; i += kCcThreads) {
        const int r = i / kCcSlice, d = c0 + i % kCcSlice, row = q0 + r;
        const bool ok = row < S && d < HD;
        Qs[r][i % kCcSlice] = ok ? to_f32(qb[row * st.q.s + d]) : 0.f;
        dOs[r][i % kCcSlice] = ok ? to_f32(db[row * st.dout.s + d]) : 0.f;
      }
      __syncthreads();
      // warp w owns keys 4w..4w+3 of the tile; lane the columns c0 + lane + 32c
#pragma unroll 4
      for (int i = 0; i < kCcTile; ++i) {
        float qv[kCcCols], ov[kCcCols];
#pragma unroll
        for (int c = 0; c < kCcCols; ++c) {
          qv[c] = Qs[i][lane + 32 * c];
          ov[c] = dOs[i][lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < kCcRows; ++j) {
          const float pj = P[i][kCcRows * warp + j], sj = dS[i][kCcRows * warp + j];
#pragma unroll
          for (int c = 0; c < kCcCols; ++c) {
            dva[j][c] = fmaf(pj, ov[c], dva[j][c]);
            dka[j][c] = fmaf(sj, qv[c], dka[j][c]);
          }
        }
      }
      // the next cc_scores opens with a barrier before P, dS, Qs or dOs
      // are written again
    }
  }
#pragma unroll
  for (int j = 0; j < kCcRows; ++j) {
    const int key = k0 + kCcRows * warp + j;
    if (key >= Skv) continue;
    T* dkrow = dk + b * st.dk.b + key * st.dk.s + hk * st.dk.h;
    T* dvrow = dv + b * st.dv.b + key * st.dv.s + hk * st.dv.h;
#pragma unroll
    for (int c = 0; c < kCcCols; ++c) {
      const int d = c0 + lane + 32 * c;
      if (d < HD) {
        dkrow[d] = from_f32<T>(dka[j][c] * scale);
        dvrow[d] = from_f32<T>(dva[j][c]);
      }
    }
  }
}

// one CTA per (slice of 64 output columns, b, q head, tile of 32 queries),
// the tiles with the most causal work first.  Two passes over the key
// tiles: D, then dQ; the first slice's CTA writes D.
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kCcThreads)
flash_bwd_dq_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ D,
                       T* __restrict__ dq, BwdStrides st, int S, int Skv, int H, int Hkv,
                       int HD, float scale) {
  __shared__ CcTiles t;
  __shared__ float dS[kCcTile][kCcTile + 1];
  __shared__ float Ks[kCcTile][kCcSlice];
  const int n_sl = (HD + kCcSlice - 1) / kCcSlice;
  const int n_qt = (S + kCcTile - 1) / kCcTile;
  const int BH = (gridDim.x / n_sl) / n_qt;
  int idx = static_cast<int>(blockIdx.x);
  const int sl = idx % n_sl;
  idx /= n_sl;
  const int bh = idx % BH, qt = n_qt - 1 - idx / BH;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * kCcTile, c0 = sl * kCcSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* db = dout + b * st.dout.b + h * st.dout.h;
  const T* kb = k + b * st.k.b + hk * st.k.h;
  const T* vb = v + b * st.v.b + hk * st.v.h;
  float* drow = D + (static_cast<int64_t>(b) * H + h) * S;

  float l_r[kCcRows], d_r[kCcRows], dqa[kCcRows][kCcCols];
#pragma unroll
  for (int r = 0; r < kCcRows; ++r) {
    const int row = q0 + kCcRows * warp + r;
    l_r[r] = row < S ? lse[(static_cast<int64_t>(b) * H + h) * S + row] : 0.f;
    d_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCcCols; ++c) dqa[r][c] = 0.f;
  }
  const int k_end = CAUSAL ? min(S, q0 + kCcTile) : Skv;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < k_end; k0 += kCcTile) {
      float s[kCcRows], dp[kCcRows];
      cc_scores(t, qb, db, kb, vb, st.q.s, st.dout.s, st.k.s, st.v.s, q0, k0, S, Skv, HD,
                s, dp);
      const int key = k0 + lane;
#pragma unroll
      for (int r = 0; r < kCcRows; ++r) {
        const int row = q0 + kCcRows * warp + r;
        const bool ok = row < S && key < Skv && (!CAUSAL || key <= row);
        const float p = ok ? expf(fmaf(s[r], scale, -l_r[r])) : 0.f;
        if (pass == 0)
          d_r[r] = fmaf(p, dp[r], d_r[r]);          // this lane's keys; summed below
        else
          dS[kCcRows * warp + r][lane] = p * (dp[r] - d_r[r]);
      }
      if (pass == 0) continue;
      for (int i = threadIdx.x; i < kCcTile * kCcSlice; i += kCcThreads) {
        const int j = i / kCcSlice, d = c0 + i % kCcSlice, kk = k0 + j;
        Ks[j][i % kCcSlice] = kk < Skv && d < HD ? to_f32(kb[kk * st.k.s + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kCcTile; ++j) {
        float kv[kCcCols];
#pragma unroll
        for (int c = 0; c < kCcCols; ++c) kv[c] = Ks[j][lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kCcRows; ++r) {
          const float sj = dS[kCcRows * warp + r][j];
#pragma unroll
          for (int c = 0; c < kCcCols; ++c) dqa[r][c] = fmaf(sj, kv[c], dqa[r][c]);
        }
      }
      // the next cc_scores opens with a barrier before dS or Ks are
      // written again
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < kCcRows; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d_r[r] += __shfl_xor_sync(kFull, d_r[r], off);
        const int row = q0 + kCcRows * warp + r;
        if (sl == 0 && lane == 0 && row < S) drow[row] = d_r[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kCcRows; ++r) {
    const int row = q0 + kCcRows * warp + r;
    if (row >= S) continue;
    T* dqrow = dq + b * st.dq.b + row * st.dq.s + h * st.dq.h;
#pragma unroll
    for (int c = 0; c < kCcCols; ++c) {
      const int d = c0 + lane + 32 * c;
      if (d < HD) dqrow[d] = from_f32<T>(dqa[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core route: bf16, hd <= 128
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcTile = 64;                 // keys and queries of a tile
constexpr int kTcWarpRows = kTcTile / kTcWarps;   // 16: one m16 fragment
constexpr int kTcNBlocks = kTcTile / 8;     // n8 blocks across a tile: 8

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory geometry for head dim HD: tiles of 64 rows of HD bf16,
// each row padded by 8 elements (16 B) so that ldmatrix's eight row reads
// of an 8x8 matrix land in distinct banks.
template <int HD>
struct TcGeom {
  static constexpr int kStride = HD + 8;            // elements a row
  static constexpr int kTileBytes = kTcTile * kStride * 2;
  // six tiles (two kept, two double-buffered), then two stages of 64 lse
  // and 64 D floats (dK/dV only)
  static constexpr int kSmemBytes = 6 * kTileBytes + 2 * 2 * kTcTile * 4;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
};

// cp.async of rows [row0, row0 + 64) of a [rows, HD] bf16 matrix (row
// stride rs) into a padded tile; rows past n_rows are zero-filled
template <int HD>
__device__ __forceinline__ void tc_load_tile(uint32_t dst, const bf16* src, int64_t rs,
                                             int row0, int n_rows) {
  constexpr int kChunks = HD / 8;                   // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTcTile * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + (r * TcGeom<HD>::kStride + c * 8) * 2,
               src + (ok ? row * rs + c * 8 : 0), ok);
  }
}

// A fragment (16x16, rows r0.., columns c0..) of a padded tile
template <int HD>
__device__ __forceinline__ void tc_frag_a(uint32_t tile, int r0, int c0, uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + ((r0 + lane % 16) * TcGeom<HD>::kStride + c0 + (lane / 16) * 8) * 2, a);
}

// B fragments of two n8 blocks (n0.., n0 + 8..) at k columns k0.. of a
// tile stored [n][k] (q or k rows for S = Q K^T): {b0, b1} of n0, {b2, b3}
// of n0 + 8
template <int HD>
__device__ __forceinline__ void tc_frag_b_nk(uint32_t tile, int n0, int k0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(tile + ((n0 + lane % 8 + (lane / 16) * 8) * TcGeom<HD>::kStride + k0
                  + ((lane / 8) % 2) * 8) * 2, b);
}

// the same from a tile stored [k][n] (rows of dO, Q or K feeding a
// product over the tile's rows), through ldmatrix's transpose
template <int HD>
__device__ __forceinline__ void tc_frag_b_kn(uint32_t tile, int k0, int n0, uint32_t (&b)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(tile + ((k0 + lane % 16) * TcGeom<HD>::kStride + n0 + (lane / 16) * 8) * 2,
                b);
}

// acc[16 x 64] = X_w[16 x HD] Y[64 x HD]^T: this warp's 16 rows of tile
// x against the 64 rows of tile y
template <int HD>
__device__ __forceinline__ void tc_scores(uint32_t x, uint32_t y, int r0,
                                          float (&acc)[kTcNBlocks][4]) {
#pragma unroll
  for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    tc_frag_a<HD>(x, r0, kk * 16, a);
#pragma unroll
    for (int np = 0; np < kTcNBlocks / 2; ++np) {
      uint32_t b[4];
      tc_frag_b_nk<HD>(y, np * 16, kk * 16, b);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out[16 x HD] += W[16 x 64] Z[64 x HD], W from registers (the score
// accumulator layout, carried as big + small bf16 parts) and Z a tile
// stored [64][HD]
template <int HD>
__device__ __forceinline__ void tc_accumulate(const float (&w)[kTcNBlocks][4], uint32_t z,
                                              float (&out)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kTcNBlocks / 2; ++kk) {
    uint32_t big[4], small[4];
    sm90::split_bf16(w[2 * kk][0], w[2 * kk][1], big[0], small[0]);
    sm90::split_bf16(w[2 * kk][2], w[2 * kk][3], big[1], small[1]);
    sm90::split_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1], big[2], small[2]);
    sm90::split_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3], big[3], small[3]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      tc_frag_b_kn<HD>(z, kk * 16, np * 16, b);
      mma_bf16(out[2 * np], big, b[0], b[1]);
      mma_bf16(out[2 * np], small, b[0], b[1]);
      mma_bf16(out[2 * np + 1], big, b[2], b[3]);
      mma_bf16(out[2 * np + 1], small, b[2], b[3]);
    }
  }
}

// rows of an accumulator [16 x HD] (rows row_lo and row_lo + 8 of this
// thread) times `mul`, as bf16 pairs into dst rows (row stride rs)
template <int HD>
__device__ __forceinline__ void tc_store(const float (&acc)[HD / 8][4], bf16* dst, int64_t rs,
                                         int row_lo, int n_rows, float mul) {
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= n_rows) continue;
    bf16* out = dst + row * rs;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<uint32_t*>(out + nb * 8 + col) =
          sm90::pack_bf16(acc[nb][2 * half] * mul, acc[nb][2 * half + 1] * mul);
  }
}

// one CTA per (tile of 64 keys, b, kv head), the tiles with the most
// causal work (the first keys) first
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ D,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, BwdStrides st, int S,
                         int Skv, int H, int Hkv, float c, float scale) {
  using G = TcGeom<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t sK = base, sV = base + G::kTileBytes;
  auto sQ = [&](int stage) { return base + (2 + 2 * stage) * G::kTileBytes; };
  auto sO = [&](int stage) { return base + (3 + 2 * stage) * G::kTileBytes; };
  float* sL = reinterpret_cast<float*>(smem + 6 * G::kTileBytes);   // [2][64] lse
  float* sD = sL + 2 * kTcTile;                                       // [2][64] D

  const int BHkv = static_cast<int>(gridDim.x) / ((Skv + kTcTile - 1) / kTcTile);
  const int kt = static_cast<int>(blockIdx.x) / BHkv, bh = static_cast<int>(blockIdx.x) % BHkv;
  const int b = bh / Hkv, hk = bh % Hkv, group = H / Hkv;
  const int k0 = kt * kTcTile;
  const int n_qt = (S + kTcTile - 1) / kTcTile;
  const int qt0 = CAUSAL ? kt : 0;
  const int per_head = n_qt - qt0;
  const int n_iter = group * per_head;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * kTcWarpRows;               // this warp's keys in the tile
  const int col = 2 * (lane % 4);                  // accumulator columns col, col + 1

  auto issue = [&](int it, int stage) {
    const int h = hk * group + it / per_head, q0 = (qt0 + it % per_head) * kTcTile;
    tc_load_tile<HD>(sQ(stage), q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
    tc_load_tile<HD>(sO(stage), dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, S);
    const int64_t row = (static_cast<int64_t>(b) * H + h) * S + q0;
    if (tid < kTcTile) {
      const bool ok = q0 + tid < S;
      cp_async4(sm90::smem_addr(sL + stage * kTcTile + tid), lse + (ok ? row + tid : 0), ok);
    } else {
      const int i = tid - kTcTile;
      const bool ok = q0 + i < S;
      cp_async4(sm90::smem_addr(sD + stage * kTcTile + i), D + (ok ? row + i : 0), ok);
    }
  };

  tc_load_tile<HD>(sK, k + b * st.k.b + hk * st.k.h, st.k.s, k0, Skv);
  tc_load_tile<HD>(sV, v + b * st.v.b + hk * st.v.h, st.v.s, k0, Skv);
  issue(0, 0);
  cp_async_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) {
      issue(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qt0 + it % per_head) * kTcTile;
    const float* lq = sL + stage * kTcTile;
    const float* dd = sD + stage * kTcTile;

    // P^T = 2^(c K Q^T - lse log2 e): rows are keys, columns queries
    float p[kTcNBlocks][4];
    tc_scores<HD>(sK, sQ(stage), r0, p);
    const bool edge = q0 + kTcTile > S || (CAUSAL && q0 == k0);
#pragma unroll
    for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nb * 8 + col + (e % 2);
        float x = sm90::exp2_approx(fmaf(p[nb][e], c, -lq[qi] * kLog2e));
        if (edge) {
          const int key = k0 + r0 + lane / 4 + 8 * (e / 2), row = q0 + qi;
          if (row >= S || (CAUSAL && key > row)) x = 0.f;
        }
        p[nb][e] = x;
      }
    // dV += P^T dO
    tc_accumulate<HD>(p, sO(stage), dva);
    // dS^T = P^T (dP^T - D), dP^T = V dO^T
    float ds[kTcNBlocks][4];
    tc_scores<HD>(sV, sO(stage), r0, ds);
#pragma unroll
    for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nb][e] = p[nb][e] * (ds[nb][e] - dd[nb * 8 + col + (e % 2)]);
    // dK += dS^T Q (scaled at the end)
    tc_accumulate<HD>(ds, sQ(stage), dka);
    __syncthreads();                                // the stage is refilled next
  }

  const int key_lo = k0 + r0 + lane / 4;
  tc_store<HD>(dka, dk + b * st.dk.b + hk * st.dk.h, st.dk.s, key_lo, Skv, scale);
  tc_store<HD>(dva, dv + b * st.dv.b + hk * st.dv.h, st.dv.s, key_lo, Skv, 1.f);
}

// one CTA per (b, q head, tile of 64 queries), the tiles with the most
// causal work first.  Its key tiles twice through one double-buffered
// ring: iterations [0, n_kt) sum D, [n_kt, 2 n_kt) accumulate dQ.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ D,
                       bf16* __restrict__ dq, BwdStrides st, int S, int Skv, int H, int Hkv,
                       float c, float scale) {
  using G = TcGeom<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t sQ = base, sO = base + G::kTileBytes;
  auto sK = [&](int stage) { return base + (2 + 2 * stage) * G::kTileBytes; };
  auto sV = [&](int stage) { return base + (3 + 2 * stage) * G::kTileBytes; };

  const int n_qt = (S + kTcTile - 1) / kTcTile;
  const int BH = static_cast<int>(gridDim.x) / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = qt * kTcTile;
  const int k_end = CAUSAL ? min(S, q0 + kTcTile) : Skv;
  const int n_kt = (k_end + kTcTile - 1) / kTcTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * kTcWarpRows;
  const int col = 2 * (lane % 4);
  const int row_lo = q0 + r0 + lane / 4;           // this thread's rows: row_lo, row_lo + 8
  const bf16* kb = k + b * st.k.b + hk * st.k.h;
  const bf16* vb = v + b * st.v.b + hk * st.v.h;

  tc_load_tile<HD>(sQ, q + b * st.q.b + h * st.q.h, st.q.s, q0, S);
  tc_load_tile<HD>(sO, dout + b * st.dout.b + h * st.dout.h, st.dout.s, q0, S);
  tc_load_tile<HD>(sK(0), kb, st.k.s, 0, Skv);
  tc_load_tile<HD>(sV(0), vb, st.v.s, 0, Skv);
  cp_async_commit();

  const int64_t rbase = (static_cast<int64_t>(b) * H + h) * S;
  float l2[2], dr[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    l2[half] = row < S ? lse[rbase + row] * kLog2e : 0.f;
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nb][e] = 0.f;

  for (int it = 0; it < 2 * n_kt; ++it) {
    const int stage = it & 1;
    if (it + 1 < 2 * n_kt) {
      const int next = ((it + 1) % n_kt) * kTcTile;
      tc_load_tile<HD>(sK(stage ^ 1), kb, st.k.s, next, Skv);
      tc_load_tile<HD>(sV(stage ^ 1), vb, st.v.s, next, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (it % n_kt) * kTcTile;
    // P = 2^(c Q K^T - lse log2 e)
    float p[kTcNBlocks][4];
    tc_scores<HD>(sQ, sK(stage), r0, p);
    const bool edge = k0 + kTcTile > Skv || q0 + kTcTile > S || (CAUSAL && k0 + kTcTile > q0);
#pragma unroll
    for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sm90::exp2_approx(fmaf(p[nb][e], c, -l2[e / 2]));
        if (edge) {
          const int key = k0 + nb * 8 + col + (e % 2), row = row_lo + 8 * (e / 2);
          if (key >= Skv || row >= S || (CAUSAL && key > row)) x = 0.f;
        }
        p[nb][e] = x;
      }
    // dP = dO V^T
    float ds[kTcNBlocks][4];
    tc_scores<HD>(sO, sV(stage), r0, ds);
    if (it < n_kt) {
      // D: this thread's columns now, the quad's four after the last tile
#pragma unroll
      for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dr[e / 2] = fmaf(p[nb][e], ds[nb][e], dr[e / 2]);
      if (it == n_kt - 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          dr[half] += __shfl_xor_sync(kFull, dr[half], 1);
          dr[half] += __shfl_xor_sync(kFull, dr[half], 2);
          const int row = row_lo + 8 * half;
          if (lane % 4 == 0 && row < S) D[rbase + row] = dr[half];
        }
      }
    } else {
      // dS = P (dP - D); dQ += dS K (scaled at the end)
#pragma unroll
      for (int nb = 0; nb < kTcNBlocks; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[nb][e] = p[nb][e] * (ds[nb][e] - dr[e / 2]);
      tc_accumulate<HD>(ds, sK(stage), dqa);
    }
    __syncthreads();                                // the stage is refilled next
  }
  tc_store<HD>(dqa, dq + b * st.dq.b + h * st.dq.h, st.dq.s, row_lo, S, scale);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  BwdStrides st;
  int B, S, Skv, H, Hkv, hd;
  float scale;                              // 1 / sqrt(scale_hd)
};

template <typename T, bool CAUSAL>
cudaError_t launch_cc(const Args& a, cudaStream_t stream) {
  const int n_sl = (a.hd + kCcSlice - 1) / kCcSlice;
  const unsigned q_grid = static_cast<unsigned>(a.B) * a.H *
                          ((a.S + kCcTile - 1) / kCcTile) * n_sl;
  flash_bwd_dq_cc_kernel<T, CAUSAL><<<q_grid, kCcThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.D, static_cast<T*>(a.dq), a.st, a.S, a.Skv,
      a.H, a.Hkv, a.hd, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned kv_grid = static_cast<unsigned>(a.B) * a.Hkv *
                           ((a.Skv + kCcTile - 1) / kCcTile) * n_sl;
  flash_bwd_dkdv_cc_kernel<T, CAUSAL><<<kv_grid, kCcThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.D, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.st, a.S, a.Skv, a.H, a.Hkv, a.hd, a.scale);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using G = TcGeom<HD>;
  auto dq = flash_bwd_dq_tc_kernel<HD, CAUSAL>;
  auto dkdv = flash_bwd_dkdv_tc_kernel<HD, CAUSAL>;
  static bool configured = false;           // per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           G::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 G::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float c = kLog2e * a.scale;
  const unsigned q_grid = static_cast<unsigned>(a.B) * a.H * ((a.S + kTcTile - 1) / kTcTile);
  dq<<<q_grid, kTcThreads, G::kSmemBytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.D,
      static_cast<bf16*>(a.dq), a.st, a.S, a.Skv, a.H, a.Hkv, c, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned kv_grid = static_cast<unsigned>(a.B) * a.Hkv *
                           ((a.Skv + kTcTile - 1) / kTcTile);
  dkdv<<<kv_grid, kTcThreads, G::kSmemBytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.D,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.st, a.S, a.Skv, a.H, a.Hkv, c,
      a.scale);
  return cudaGetLastError();
}

template <bool CAUSAL>
cudaError_t dispatch_tc(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 16: return launch_tc<16, CAUSAL>(a, stream);
    case 32: return launch_tc<32, CAUSAL>(a, stream);
    case 64: return launch_tc<64, CAUSAL>(a, stream);
    case 96: return launch_tc<96, CAUSAL>(a, stream);
    case 128: return launch_tc<128, CAUSAL>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* dout, const float* lse,
          float* D, void* dq, void* dk, void* dv, int causal, int B, int S, int Skv, int H,
          int Hkv, int hd, int scale_hd, const int64_t* strides, cudaStream_t stream,
          bool tensor_cores) {
  if (S == 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (Skv < 1 || (causal && Skv != S) || Hkv <= 0 || H % Hkv != 0 || hd < 1 ||
      scale_hd < 1 || scale_hd > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, lse, D, dq, dk, dv, {}, B, S, Skv, H, Hkv, hd,
         1.0f / sqrtf(static_cast<float>(scale_hd))};
  Strides* st[7] = {&a.st.q, &a.st.k, &a.st.v, &a.st.dout, &a.st.dq, &a.st.dk, &a.st.dv};
  for (int i = 0; i < 7; ++i)
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaError_t err;
  if (tensor_cores)
    err = causal ? dispatch_tc<true>(a, stream) : dispatch_tc<false>(a, stream);
  else
    err = causal ? launch_cc<T, true>(a, stream) : launch_cc<T, false>(a, stream);
  return static_cast<int>(err);
}

}  // namespace

// Launch the backward on `stream` (two kernels: dQ, which also fills D,
// then dK/dV) and return cudaGetLastError() (0 on success).  q, dO, dq
// are [B, S, H, hd] and k, v, dk, dv [B, Skv, Hkv, hd] (Skv == S when
// causal), each with the b, s, h element strides in `strides` (21 values:
// q, k, v, dO, dq, dk, dv, in that order) and its last axis contiguous;
// lse and D are float32 [B, H, S], contiguous: lse the forward's row
// log-sum-exp in natural units, D workspace the call fills.  hd is the
// kernels' head dim (any hd >= 1 in float32; 16, 32, 64, 96 or 128, or any
// hd above 128, in bf16), scale_hd in [1, hd] the one whose 1/sqrt scales
// the scores.  S == 0 launches nothing.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, float* D,
                                       void* dq, void* dk, void* dv, int causal, int B,
                                       int S, int Skv, int H, int Hkv, int hd, int scale_hd,
                                       const int64_t* strides, cudaStream_t stream) {
  return entry<float>(q, k, v, dout, lse, D, dq, dk, dv, causal, B, S, Skv, H, Hkv, hd,
                      scale_hd, strides, stream, false);
}

// The same on bfloat16 tensors: hd <= 128 on the tensor cores (bases and
// b/s/h strides of q, k, v and dO 16-byte multiples, for cp.async), above
// 128 on the CUDA cores.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, float* D,
                                        void* dq, void* dk, void* dv, int causal, int B,
                                        int S, int Skv, int H, int Hkv, int hd, int scale_hd,
                                        const int64_t* strides, cudaStream_t stream) {
  return entry<bf16>(q, k, v, dout, lse, D, dq, dk, dv, causal, B, S, Skv, H, Hkv, hd,
                     scale_hd, strides, stream, hd <= 128);
}
