// Per-row top-2 and flip regret of a proto-action, for the K-NN projection.
//
// Replaces the TPU kernel repro/kernels/knn_topk/kernel.py::row_top2_regret
// (Pallas body _top2_kernel).  For every row r of proto [rows, m] (float32,
// row-major, contiguous, the base 4-byte aligned):
//   best[r]   = first index of the row maximum (jnp.argmax semantics);
//   second[r] = first index of the maximum after the best column is masked
//               to -1e30 (the Pallas kernel's masked argmax);
//   regret[r] = 2.0f * (proto[r, best] - masked max), in float32.
// The three land in one int32 buffer out [3, rows]: best, second, and the
// bits of regret.
//
// Order (`beats` below): a value beats the running maximum if it is greater,
// or if it is NaN and the maximum is not.  Scanning left to right, the first
// index wins ties (-0.0 ties 0.0) and the first NaN of a row is its maximum,
// as jnp.argmax and torch.argmax have it; the masked pass ranks the other
// columns by the same rule, so the masked best column (-1e30) is second on a
// row whose other values are all below -1e30 or -inf.  Two passes, as the
// Pallas kernel has them: a one-pass running top-2 is not this function.
//
// Bound on an H100: bytes.  The function reads rows*m*4 bytes and writes
// rows*12: 1.3 MB at the DDPG update's 25,600 x 10, about 0.4 us at 3.35
// TB/s, and the ~2m compares per row are nothing beside that.  At these
// sizes a call is a launch, one round trip to memory and a few hundred
// cycles of dependent selects, so the design keeps every load of a thread
// in flight at once and every pass in registers.  On an H100 (700 W) it
// takes 1.63-1.65 us a call at 25,600 x 10, where a 1-element fill_ takes
// 0.86-0.87 us in the same CUDA-graph harness (chip_smoke.py, phase 3).
//
// Design, 2 <= m <= 16 (m a template parameter): a CTA of kRows threads
// takes a tile of kRows rows, which is kRows*m contiguous floats.  It copies
// the tile into shared memory with 16-byte loads, all issued before the
// first store: a base off the 16-byte grid (a view such as proto[1:]) is
// copied by a scalar head of up to 3 floats, the aligned body as float4, a
// scalar tail of up to 3.  Shared memory holds the tile at the base's offset
// within 16 bytes, so the body's float4 stores are aligned.  After one
// barrier each thread reads its row into registers, as float4 or float2
// where m and the offset allow (m = 10 as float2: no bank conflicts), else
// as floats (m = 10: 2-way conflicts), and runs both passes there, each a
// tree of log2(m) levels that keeps the scan's leftmost maximum.  Each
// warp stores best, second and regret as three runs of 32 consecutive
// words.  The last tile is ragged and copies and reduces only its rows.
// m > 16: a thread a row, the row read from global memory in chunks of
// kChunk columns, each chunk's loads issued together and its maximum taken
// by the tree; a chunk's maximum replaces the running one only if it beats
// it.  The masked pass reads the chunks again.  No main path runs m > 16.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;         // rows a CTA, one per thread
constexpr int kChunk = 16;         // columns held in registers at once
constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value

// v > cur, or v NaN and cur not, written `!(v <= cur) & (cur == cur)`: two
// compares and no branch, where `v > cur || (isnan(v) && !isnan(cur))`
// compiles to a branch a column and slows the kernel by ~40% on an H100.
__device__ __forceinline__ bool beats(float v, float cur) {
  return !(v <= cur) & (cur == cur);
}

// Leftmost maximum of val[0..N) under `beats`, into val[0] and idx[0]: a
// tree of log2(N) levels, each pair's right half taken only if it beats the
// left, so ties keep the lower index as a left-to-right scan does, with a
// chain of log2(N) compares in place of N.
template <int N>
__device__ __forceinline__ void tree_max(float (&val)[N], int (&idx)[N]) {
#pragma unroll
  for (int stride = 1; stride < N; stride *= 2) {
#pragma unroll
    for (int j = 0; j + stride < N; j += 2 * stride) {
      if (beats(val[j + stride], val[j])) {
        val[j] = val[j + stride];
        idx[j] = idx[j + stride];
      }
    }
  }
}

// (value, column) of the leftmost maximum of v[0..N), column `masked` read
// as -1e30 (none where masked lies outside [0, N)).
template <int N>
__device__ __forceinline__ void row_max(const float (&v)[N], int masked,
                                        float& best, int& at) {
  float val[N];
  int idx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    val[j] = j == masked ? kNegInf : v[j];
    idx[j] = j;
  }
  tree_max(val, idx);
  best = val[0];
  at = idx[0];
}

__device__ __forceinline__ void store(int32_t* out, int64_t rows, int64_t r,
                                      int bi, float bv, int si, float sv) {
  out[r] = bi;
  out[rows + r] = si;
  out[2 * rows + r] = __float_as_int(2.0f * (bv - sv));
}

// Reads a row of M floats from shared memory as VEC-wide loads.
template <int M, int VEC>
__device__ __forceinline__ void read_row(const float* row, float (&v)[M]) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int j = 0; j < M; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int j = 0; j < M; j += 2) {
      const float2 x = *reinterpret_cast<const float2*>(row + j);
      v[j] = x.x; v[j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = row[j];
  }
}

template <int M>
__global__ void __launch_bounds__(kRows)
top2_tile_kernel(const float* __restrict__ proto, int32_t* __restrict__ out,
                 int64_t rows) {
  static_assert(M >= 2 && M <= kChunk, "the tile kernel takes 2 <= m <= 16");
  constexpr int kTile = kRows * M;                       // floats of a tile
  constexpr int kIters = (kTile / 4 + kRows - 1) / kRows;  // float4s a thread
  constexpr int kVec = M % 4 == 0 ? 4 : M % 2 == 0 ? 2 : 1;
  __shared__ __align__(16) float tile[kTile + 4];

  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(rows - row0 < kRows ? rows - row0 : kRows);
  const int n = nrows * M;
  const float* src = proto + row0 * M;
  // floats from the last 16-byte boundary to src; kRows*M*4 bytes is a
  // multiple of 16, so every tile of a launch has the same shift
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  const int head = min((4 - shift) & 3, n);
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  float* dst = tile + shift;                 // dst[i] = src[i]
  const float4* body = reinterpret_cast<const float4*>(src + head);

  float4 buf[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int k = t + i * kRows;
    if (k < nvec) buf[i] = body[k];
  }
  const float h = t < head ? src[t] : 0.0f;
  const float e = t < n - tail ? src[tail + t] : 0.0f;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int k = t + i * kRows;
    if (k < nvec) reinterpret_cast<float4*>(dst + head)[k] = buf[i];
  }
  if (t < head) dst[t] = h;
  if (t < n - tail) dst[tail + t] = e;
  __syncthreads();
  if (t >= nrows) return;

  float v[M];
  const float* row = dst + t * M;
  if (kVec > 1 && (shift & (kVec - 1)) == 0) {
    read_row<M, kVec>(row, v);
  } else {
    read_row<M, 1>(row, v);
  }
  float bv, sv;
  int bi, si;
  row_max(v, -1, bv, bi);
  row_max(v, bi, sv, si);
  store(out, rows, row0 + t, bi, bv, si, sv);
}

// Columns [c, c + kChunk) of row p, -inf past m (it never beats a value).
__device__ __forceinline__ void load_chunk(const float* p, int c, int m,
                                           float (&v)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) v[j] = c + j < m ? p[c + j] : -INFINITY;
}

__global__ void __launch_bounds__(kRows)
top2_chunked_kernel(const float* __restrict__ proto, int32_t* __restrict__ out,
                    int64_t rows, int m) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  if (r >= rows) return;
  const float* p = proto + r * m;
  float v[kChunk], cv;
  int ci;
  // a chunk's maximum takes over only if it beats the lower columns'
  float bv = p[0];
  int bi = 0;
  for (int c = 0; c < m; c += kChunk) {
    load_chunk(p, c, m, v);
    row_max(v, -1, cv, ci);
    if (beats(cv, bv)) {
      bv = cv;
      bi = c + ci;
    }
  }
  float sv = bi == 0 ? kNegInf : p[0];
  int si = 0;
  for (int c = 0; c < m; c += kChunk) {
    load_chunk(p, c, m, v);
    row_max(v, bi - c, cv, ci);
    if (beats(cv, sv)) {
      sv = cv;
      si = c + ci;
    }
  }
  store(out, rows, r, bi, bv, si, sv);
}

template <int M>
void launch_tile(const float* proto, int32_t* out, int64_t rows,
                 unsigned int blocks, cudaStream_t stream) {
  top2_tile_kernel<M><<<blocks, kRows, 0, stream>>>(proto, out, rows);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  out is [3, rows] int32; rows == 0 launches nothing.
extern "C" int knn_row_top2_regret(const float* proto, int32_t* out,
                                   int64_t rows, int m, cudaStream_t stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const auto blocks = static_cast<unsigned int>((rows + kRows - 1) / kRows);
  switch (m) {
    case 2: launch_tile<2>(proto, out, rows, blocks, stream); break;
    case 3: launch_tile<3>(proto, out, rows, blocks, stream); break;
    case 4: launch_tile<4>(proto, out, rows, blocks, stream); break;
    case 5: launch_tile<5>(proto, out, rows, blocks, stream); break;
    case 6: launch_tile<6>(proto, out, rows, blocks, stream); break;
    case 7: launch_tile<7>(proto, out, rows, blocks, stream); break;
    case 8: launch_tile<8>(proto, out, rows, blocks, stream); break;
    case 9: launch_tile<9>(proto, out, rows, blocks, stream); break;
    case 10: launch_tile<10>(proto, out, rows, blocks, stream); break;
    case 11: launch_tile<11>(proto, out, rows, blocks, stream); break;
    case 12: launch_tile<12>(proto, out, rows, blocks, stream); break;
    case 13: launch_tile<13>(proto, out, rows, blocks, stream); break;
    case 14: launch_tile<14>(proto, out, rows, blocks, stream); break;
    case 15: launch_tile<15>(proto, out, rows, blocks, stream); break;
    case 16: launch_tile<16>(proto, out, rows, blocks, stream); break;
    default:
      top2_chunked_kernel<<<blocks, kRows, 0, stream>>>(proto, out, rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}
