// RWKV6 ("Finch") WKV recurrence with a carried state, forward only.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/kernel.py::wkv6_kernel
// (Pallas body _wkv_kernel, layout wrapper ops.wkv6), and computes the
// function of ssm._wkv_chunk / wkv6_ref, which also carry the state: for
// each (b, h), with an [hd, hd] float32 state S (S0, or zeros),
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// for t = 0 .. T-1, then S_T = S.  Inputs: w float32 and r, k, v float32
// or bfloat16, all [B, T, H, hd] with any strides over b, t and h and the
// last axis contiguous; u float32 [H, hd]; S0 float32 [B, H, hd, hd]
// contiguous, or null for zeros.  Outputs: out float32 [B, T, H, hd] and
// S_T float32 [B, H, hd, hd], both contiguous.  Every step runs: the last
// chunk is masked, so nothing is dropped for a ragged T (the chunk of the
// Pallas kernel was a VMEM blocking and changes nothing in the math).
//
// Bound on an H100: at the rwkv6-7b prefill shape (B=4, T=2048, H=64,
// hd=64, bf16 r/k/v) the function needs 5 float32 operations per state
// element and step: the bonus is an O(hd) term per step,
//   out_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i],
// so an FMA for the output and a product and an FMA for the state.  That
// is 10.7 GFLOP, 0.16 ms at 67 TFLOP/s, against 0.14 ms for the 470 MB of
// inputs and outputs.  Issued, it is 3 FP32 instructions per element and
// step (FFMA, FMUL, FFMA): 0.19 ms of FP32 issue at 1.98 GHz on 132 SMs.
// At the decode shape (T=1) it is bytes: the 8.4 MB of state in and out.
//
// Design: one CTA per (b, h).  Its state is split into row groups of
// hd / RS rows and column groups of CC columns; thread (q, j0) keeps rows
// q * hd/RS .. of columns j0 .. j0 + CC - 1 in registers for the whole
// sequence, so the state never leaves the chip between steps.  The
// blocking is RS = 8, CC = 4 at hd 16 to 64 (32 floats a thread,
// 128 threads a CTA; 8 warps an SM at the rwkv6-7b shapes) and RS = 4,
// CC = 1 at hd 8 and 128.  What it does about the limits of the one-
// thread-per-column kernel it replaces (2 CTAs of 64 threads an SM, a
// 64-long FMA chain per step, loads exposed every chunk):
// * the dependent chain: a thread's out partial for a column,
//   sum_i r_i S_ij over its rows, runs in two accumulators (even and odd
//   rows), chains of hd / (2 RS) FMAs, 4 at hd = 64;
// * the sum over the row groups: the RS groups of a column are the lanes
//   of one warp (lane = q * (32 / RS) + column group), and the partials of
//   kK steps (8 at CC = 4, else 4) are summed together by one butterfly
//   reduce-scatter of __shfl_xor_sync, ((p0 + p1) + (p2 + p3)) + ... over
//   the groups: each level halves what a lane holds, so kK steps cost
//   kK * CC * (1 - 1/RS) shuffles (28 for 8 steps at RS = 8, CC = 4), those
//   of a level independent of each other, off the steps' path;
// * the loads: each step a thread reads its rows' w, r, k as float4
//   broadcasts from shared memory (the row groups padded 4 floats apart,
//   so the groups of a warp hit distinct banks) and its columns' v; CC
//   columns share each row read, so shared-memory traffic per element falls
//   with CC, and a broadcast load costs a warp less than distinct ones;
// * the bonus: while a chunk is widened, each (step, row group) gets
//   sum_{i in group} r_i u_i k_i (sums of 4 elements, then a tree over the
//   group's lanes), and a thread adds v_j times it to its partial: one FMA,
//   so a state element still costs the function's 5 operations;
// * the staging: C steps of w, r, k and v (C = 32 at hd <= 64, 16 at
//   hd = 128, so that two CTAs fit an SM at hd = 64 in float32) are copied
//   into a two-stage ring in shared memory with cp.async, chunk n + 1 in
//   flight while chunk n is computed.  Each tensor is copied in the widest
//   unit (16, 8 or 4 bytes) that its pointer, strides and row allow, or
//   element by element where a bfloat16 view is only 2-byte aligned.  The
//   chunk is then widened to float32 once, 4 elements a thread, into the
//   padded layout the steps read;
// * the decode step (T = 1) is its own instantiation: each thread reads its
//   operands from device memory into registers, with no staging and no
//   barrier, and forms its group's bonus itself, in the same order.
// Only the order of out's sum changes against a single chain (two
// accumulators, then the tree over the row groups); the state update is
// the same fmaf per element.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// one of w, r, k, v: the address of (b, t, h) = (0, 0, 0), byte strides,
// and log2 of the bytes of one copy into shared memory: 16, 8 or 4 bytes
// by cp.async, or 2 (one bfloat16) by a load and a store
struct Input {
  const char* base;
  int64_t sb, st, sh;
  int shift;
};

constexpr int kPad = 4;                     // floats between two row groups

__host__ __device__ constexpr unsigned log2u(unsigned v) {
  return v <= 1 ? 0 : 1 + log2u(v / 2);
}

template <int W>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
                 "n"(W)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n rows (steps t0 .. t0 + n - 1) of one input at (b, h) into dst, row c at
// dst + c * ROW bytes; every thread of the CTA takes a share of the copies
template <int ROW>
__device__ __forceinline__ void stage_rows(const Input& in, int64_t bh_off,
                                           int t0, int n, char* dst) {
  constexpr unsigned kRowShift = log2u(ROW);
  const unsigned per_row = ROW >> in.shift;
  for (unsigned x = threadIdx.x; x < n * per_row; x += blockDim.x) {
    const unsigned c = x >> (kRowShift - in.shift), o = (x & (per_row - 1)) << in.shift;
    const char* src = in.base + bh_off + static_cast<int64_t>(t0 + c) * in.st + o;
    char* d = dst + c * ROW + o;
    switch (in.shift) {
      case 4: cp_async<16>(d, src); break;
      case 3: cp_async<8>(d, src); break;
      case 2: cp_async<4>(d, src); break;
      default: *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(src);
    }
  }
}

// V consecutive floats in one load
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  static_assert(V == 1 || V == 2 || V == 4, "one load of 4, 8 or 16 bytes");
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  static_assert(V == 1 || V == 2 || V == 4, "one store of 4, 8 or 16 bytes");
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else *p = x[0];
}

// V consecutive elements of the staged chunk, widened to float32
template <int V>
__device__ __forceinline__ void load_wide(const float* p, float (&x)[V]) { load_vec<V>(p, x); }

template <int V>
__device__ __forceinline__ void load_wide(const __nv_bfloat16* p, float (&x)[V]) {
  uint32_t bits[(V + 1) / 2];
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    bits[0] = t.x; bits[1] = t.y;
  } else if constexpr (V == 2) {
    bits[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    bits[0] = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    x[e] = __uint_as_float(e % 2 ? bits[e / 2] & 0xffff0000u : bits[e / 2] << 16);
}

template <typename T, int HD, int RS, int CC>
struct Plan {
  static constexpr int kCC = CC;
  static constexpr int kLanes = 32 / RS;          // lanes of a row group
  static constexpr int kThreads = HD * RS / CC;
  static constexpr int kRows = HD / RS;           // state rows per thread
  static constexpr int kVec = kRows < 4 ? kRows : 4;
  static constexpr int kGroup = kRows + kPad;     // floats per padded row group
  static constexpr int kRowP = RS * kGroup;       // a padded row of w, r, k
  static constexpr int kC = HD <= 64 ? 32 : 16;   // steps per chunk
  // one stage of the ring: w [C][HD] float32, then r, k, v [C][HD] of T
  static constexpr int kWRow = HD * 4, kXRow = HD * static_cast<int>(sizeof(T));
  static constexpr int kStage = kC * (kWRow + 3 * kXRow);
  // float32 copies: w, r, k [C][kRowP], v [C][HD], bonus partials [C][RS]
  static constexpr int kFloats = 3 * kC * kRowP + kC * HD + kC * RS + HD;
  static constexpr int kSmem = 2 * kStage + kFloats * 4;
  static constexpr int kMinBlocks = kRows * CC >= 32 ? 1 : 2;
  static constexpr int kK = CC >= 4 ? 8 : 4;      // steps per shuffle tree
  // out values a lane stores per kK steps, after the shuffle tree
  static constexpr int kHeld = kK * CC >= RS ? kK * CC / RS : 1;
  // the widening: kVec elements a thread, kPerGroup threads a row group
  static constexpr int kPerGroup = kRows / kVec;
  static constexpr int kWiden = kC * HD / kVec / kThreads;    // passes a chunk
  static_assert(HD / CC % kLanes == 0 && kThreads <= 1024 && CC <= 4, "CTA shape");
  static_assert(kWiden * kThreads * kVec == kC * HD, "widening passes");
  static_assert(kRows % kVec == 0 && kStage % 16 == 0, "alignment");
};

// one step of thread (j0, q): load(m, w, r, k) gives its rows m .. m + V - 1;
// acc gets the out partial of each of its columns, sum_i r_i S_ij in two
// accumulators (even and odd rows), and S takes the update
// S_ij = w_i S_ij + k_i v_j
template <int R, int CC, int V, typename Load>
__device__ __forceinline__ void step_math(float (&S)[R][CC], Load load, const float (&vj)[CC],
                                          float (&acc)[CC]) {
  float a0[CC] = {}, a1[CC] = {};
#pragma unroll
  for (int m = 0; m < R; m += V) {
    float wv[V], rv[V], kv[V];
    load(m, wv, rv, kv);
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int i = m + e;
        if (i % 2 == 0) a0[cc] = fmaf(rv[e], S[i][cc], a0[cc]);
        else a1[cc] = fmaf(rv[e], S[i][cc], a1[cc]);
        S[i][cc] = fmaf(wv[e], S[i][cc], kv[e] * vj[cc]);
      }
  }
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) acc[cc] = a0[cc] + a1[cc];
}

// one level of the shuffle tree over the row groups, at lane bit
// kLanes << L, and the levels above it: a lane keeps half of the values it
// holds, its upper half if its lane bit is set, and adds the partner's copy
// of that half; once one value is left, the levels that remain add it
// whole.  first is the index of the first value kept; copy marks a lane
// whose value another lane also holds.  The levels are unrolled at compile
// time, so part stays in registers.
template <typename P, int L>
__device__ __forceinline__ void tree_level(float (&part)[P::kK * P::kCC], int lane, int& first,
                                           bool& copy) {
  constexpr int d = P::kLanes << L, m = (P::kK * P::kCC) >> (L + 1);
  if constexpr (d < 32) {
    const bool up = lane & d;
    if constexpr (m >= 1) {
#pragma unroll
      for (int x = 0; x < m; ++x) {
        const float keep = up ? part[m + x] : part[x];
        const float send = up ? part[x] : part[m + x];
        part[x] = keep + __shfl_xor_sync(0xffffffffu, send, d);
      }
      if (up) first += m;
    } else {
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], d);
      copy = copy || up;
    }
    tree_level<P, L + 1>(part, lane, first, copy);
  }
}

// the out partials of kK steps, [step][column], summed over the row groups
// by the tree above, ((p0 + p1) + (p2 + p3)) for RS = 4, and stored.  The
// steps are t0 + c0 .. t0 + c0 + kK - 1; those from n on are not stored.
template <typename P>
__device__ __forceinline__ void sum_and_store(float (&part)[P::kK * P::kCC], int lane,
                                              float* ob, int64_t o_t, int t0, int c0,
                                              int n) {
  constexpr int CC = P::kCC;
  int first = 0;
  bool copy = false;
  tree_level<P, 0>(part, lane, first, copy);
#pragma unroll
  for (int x = 0; x < P::kHeld; ++x) {
    const int st = (first + x) / CC, cc = (first + x) % CC;
    if (!copy && c0 + st < n) ob[(t0 + c0 + st) * o_t + cc] = part[x];
  }
}

// element i of one input's row at byte address p, as float32
template <typename T>
__device__ __forceinline__ float load_elem(const char* p, int i) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  else
    return reinterpret_cast<const float*>(p)[i];
}

template <typename T, int HD, int RS, int CC, bool ONE_STEP>
__global__ void __launch_bounds__(HD * RS / CC, Plan<T, HD, RS, CC>::kMinBlocks)
wkv6_kernel(Input w, Input r, Input k, Input v, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ out,
            float* __restrict__ s_out, int T_, int H) {
  using P = Plan<T, HD, RS, CC>;
  constexpr int C = P::kC, R = P::kRows, G = P::kGroup, RP = P::kRowP;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = lane / P::kLanes;                 // row group
  const int j0 = ((tid >> 5) * P::kLanes + lane % P::kLanes) * CC;   // first column
  const int64_t off_w = b * w.sb + h * w.sh, off_r = b * r.sb + h * r.sh;
  const int64_t off_k = b * k.sb + h * k.sh, off_v = b * v.sb + h * v.sh;

  float S[R][CC] = {};
  const int64_t s_base = static_cast<int64_t>(bh) * HD * HD + q * R * HD + j0;
  if (s0 && reinterpret_cast<uintptr_t>(s0) % (4 * CC) == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) load_vec<CC>(s0 + s_base + i * HD, S[i]);
  } else if (s0) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) S[i][cc] = s0[s_base + i * HD + cc];
  }

  // out is contiguous [B, T, H, HD]
  float* ob = out + (static_cast<int64_t>(b) * T_ * H + h) * HD + j0;
  const int64_t o_t = static_cast<int64_t>(H) * HD;

  if constexpr (ONE_STEP) {
    // the decode step: the operands straight from device memory into
    // registers, no staging and no barrier; the bonus partial in the
    // widening's order (sums of kVec elements, then their tree)
    constexpr int V = P::kVec;
    const int i0 = q * R;
    float vj[CC], sub[P::kPerGroup], acc[CC], part[P::kK * CC] = {};
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) vj[cc] = load_elem<T>(v.base + off_v, j0 + cc);
    step_math<R, CC, V>(S, [&](int m, float (&wv)[V], float (&rv)[V], float (&kv)[V]) {
      sub[m / V] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        wv[e] = load_elem<float>(w.base + off_w, i0 + m + e);
        rv[e] = load_elem<T>(r.base + off_r, i0 + m + e);
        kv[e] = load_elem<T>(k.base + off_k, i0 + m + e);
        sub[m / V] = fmaf(rv[e] * u[h * HD + i0 + m + e], kv[e], sub[m / V]);
      }
    }, vj, acc);
#pragma unroll
    for (int d = 1; d < P::kPerGroup; d <<= 1)
#pragma unroll
      for (int g = 0; g < P::kPerGroup; g += 2 * d) sub[g] += sub[g + d];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) part[cc] = fmaf(vj[cc], sub[0], acc[cc]);
    sum_and_store<P>(part, lane, ob, o_t, 0, 0, 1);
  } else {
    extern __shared__ __align__(16) char smem[];
    float* wc = reinterpret_cast<float*>(smem + 2 * P::kStage);
    float* rc = wc + C * RP;
    float* kc = rc + C * RP;
    float* vc = kc + C * RP;
    float* bonus = vc + C * HD;                   // [C][RS]
    float* uc = bonus + C * RS;
    auto stage = [&](int t0, int n, char* dst) {
      stage_rows<P::kWRow>(w, off_w, t0, n, dst);
      dst += C * P::kWRow;
      stage_rows<P::kXRow>(r, off_r, t0, n, dst);
      stage_rows<P::kXRow>(k, off_k, t0, n, dst + C * P::kXRow);
      stage_rows<P::kXRow>(v, off_v, t0, n, dst + 2 * C * P::kXRow);
      cp_async_commit();
    };
    stage(0, min(C, T_), smem);
    for (int i = tid; i < HD; i += P::kThreads) uc[i] = u[h * HD + i];
    const int n_chunks = (T_ + C - 1) / C;
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int t0 = ci * C, n = min(C, T_ - t0);
      cp_async_wait_all();
      __syncthreads();        // chunk ci has landed; chunk ci - 1 is consumed
      const char* raw = smem + (ci & 1) * P::kStage;
      if (ci + 1 < n_chunks)
        stage(t0 + C, min(C, T_ - t0 - C), smem + ((ci + 1) & 1) * P::kStage);

      // widen the chunk to float32, kVec consecutive elements of one row
      // group a thread, into the padded layout; on the way form each (step,
      // row group)'s bonus partial, a sequential sum over the thread's
      // elements and then a tree over the group's kPerGroup lanes.  Every
      // thread makes the same passes, so the shuffles see whole warps.
      const float* wr = reinterpret_cast<const float*>(raw);
      const T* rr = reinterpret_cast<const T*>(raw + C * P::kWRow);
      const T* kr = rr + C * HD;
      const T* vr = kr + C * HD;
#pragma unroll
      for (int pass = 0; pass < P::kWiden; ++pass) {
        const unsigned x = (pass * P::kThreads + tid) * P::kVec;  // of [C][HD]
        const unsigned c = x / HD, i = x % HD;
        float part = 0.f;
        if (c < static_cast<unsigned>(n)) {
          float wv[P::kVec], rv[P::kVec], kv[P::kVec], vv[P::kVec];
          load_wide<P::kVec>(wr + x, wv);
          load_wide<P::kVec>(rr + x, rv);
          load_wide<P::kVec>(kr + x, kv);
          load_wide<P::kVec>(vr + x, vv);
          const unsigned p = c * RP + (i / R) * G + i % R;
          store_vec<P::kVec>(wc + p, wv);
          store_vec<P::kVec>(rc + p, rv);
          store_vec<P::kVec>(kc + p, kv);
          store_vec<P::kVec>(vc + x, vv);
#pragma unroll
          for (int e = 0; e < P::kVec; ++e) part = fmaf(rv[e] * uc[i + e], kv[e], part);
        }
#pragma unroll
        for (int d = 1; d < P::kPerGroup; d <<= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
        if (c < static_cast<unsigned>(n) && i % R == 0) bonus[c * RS + i / R] = part;
      }
      __syncthreads();

      // K steps at a time: each step's partials stay in registers and the K
      // steps' sums over the row groups go through one shuffle tree
      for (int c0 = 0; c0 < n; c0 += P::kK) {
        float part[P::kK * CC] = {};                // [step][column]
#pragma unroll
        for (int st = 0; st < P::kK; ++st) {
          const int c = c0 + st;
          if (c0 + P::kK > n && c >= n) break;      // a full group runs straight through
          const float* wp = wc + c * RP + q * G;
          const float* rp = rc + c * RP + q * G;
          const float* kp = kc + c * RP + q * G;
          float vj[CC], acc[CC];
          load_vec<CC>(vc + c * HD + j0, vj);
          step_math<R, CC, P::kVec>(
              S, [&](int m, float (&wv)[P::kVec], float (&rv)[P::kVec], float (&kv)[P::kVec]) {
                load_vec<P::kVec>(wp + m, wv);
                load_vec<P::kVec>(rp + m, rv);
                load_vec<P::kVec>(kp + m, kv);
              }, vj, acc);
          const float bq = bonus[c * RS + q];
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) part[st * CC + cc] = fmaf(vj[cc], bq, acc[cc]);
        }
        sum_and_store<P>(part, lane, ob, o_t, t0, c0, n);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) store_vec<CC>(s_out + s_base + i * HD, S[i]);
}

template <typename T, int HD, int RS, int CC>
cudaError_t launch(const Input* in, const float* u, const float* s0, float* out,
                   float* s_out, int B, int T_, int H, cudaStream_t stream) {
  using P = Plan<T, HD, RS, CC>;
  if (T_ == 1) {                            // the decode step: no staging
    wkv6_kernel<T, HD, RS, CC, true><<<B * H, P::kThreads, 0, stream>>>(
        in[0], in[1], in[2], in[3], u, s0, out, s_out, T_, H);
    return cudaGetLastError();
  }
  // set for the current device at every launch: the attribute belongs to a
  // device's context, and setting it is cheap
  auto kernel = wkv6_kernel<T, HD, RS, CC, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, P::kThreads, P::kSmem, stream>>>(in[0], in[1], in[2], in[3], u, s0,
                                                   out, s_out, T_, H);
  return cudaGetLastError();
}

// the blocking (RS, CC) for each head dim, see the note at the top
template <typename T>
cudaError_t dispatch(const Input* in, const float* u, const float* s0, float* out,
                     float* s_out, int B, int T_, int H, int hd, cudaStream_t stream) {
#define WKV6_LAUNCH(HD, RS, CC) launch<T, HD, RS, CC>(in, u, s0, out, s_out, B, T_, H, stream)
  switch (hd) {
    case 8: return WKV6_LAUNCH(8, 4, 1);
    case 16: return WKV6_LAUNCH(16, 8, 4);
    case 32: return WKV6_LAUNCH(32, 8, 4);
    case 64: return WKV6_LAUNCH(64, 8, 4);
    case 128: return WKV6_LAUNCH(128, 4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef WKV6_LAUNCH
}

// log2 of the widest copy, 16, 8 or 4 bytes, that a tensor's base, b/t/h
// strides and row of hd elements all allow; else of one element (2 bytes,
// bfloat16)
int copy_shift(const void* p, const int64_t* strides, int esize, int hd) {
  for (int sh = 4; sh >= 2; --sh) {
    const int wd = 1 << sh;
    bool ok = reinterpret_cast<uintptr_t>(p) % wd == 0 && (hd * esize) % wd == 0;
    for (int i = 0; i < 3; ++i) ok = ok && (strides[i] * esize) % wd == 0;
    if (ok) return sh;
  }
  return esize == 2 ? 1 : 2;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  dtype (of r, k, v): 0 float32, 1 bfloat16.  strides: 12
// element strides, (b, t, h) of w, r, k and v in that order.  s0 may be
// null (zero state).  out and s_out are contiguous and 16-byte aligned, as
// the wrapper allocates them.  B*H == 0 launches nothing.
extern "C" int wkv6_fwd(const float* w, const void* r, const void* k,
                        const void* v, const float* u, const float* s0,
                        float* out, float* s_out, int dtype, int B, int T_,
                        int H, int hd, const int64_t* strides,
                        cudaStream_t stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {w, r, k, v};
  Input in[4];
  for (int i = 0; i < 4; ++i) {
    const int esize = (i == 0 || dtype == 0) ? 4 : 2;
    const int64_t* st = strides + 3 * i;
    in[i] = Input{static_cast<const char*>(ptrs[i]), st[0] * esize, st[1] * esize,
                  st[2] * esize, copy_shift(ptrs[i], st, esize, hd)};
  }
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(in, u, s0, out, s_out, B, T_, H, hd, stream)
                 : dispatch<__nv_bfloat16>(in, u, s0, out, s_out, B, T_, H, hd, stream);
  return static_cast<int>(err);
}
