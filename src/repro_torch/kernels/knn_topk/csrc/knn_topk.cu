// Per-row top-2 and flip regret of a proto-action, for the K-NN projection.
//
// Replaces the TPU kernel repro/kernels/knn_topk/kernel.py::row_top2_regret
// (Pallas body _top2_kernel).  For every row r of proto [rows, m] (float32,
// row-major, contiguous):
//   best[r]   = first index of the row maximum (jnp.argmax semantics);
//   second[r] = first index of the maximum after the best column is masked
//               to -1e30 (the Pallas kernel's masked argmax);
//   regret[r] = 2.0f * (proto[r, best] - masked max), in float32.
// Strict '>' while scanning left to right makes the first index win ties,
// as jnp.argmax and the stable lax.top_k do.
//
// Bound on an H100: bytes.  The function reads rows*m*4 bytes and writes
// rows*12 (two int32 and one float32 per row): 1.3 MB at the DDPG update's
// 25,600 x 10, about 0.4 us at 3.35 TB/s, and the ~20 compares per row are
// nothing beside that.  At these sizes the launch itself dominates.
//
// Design: one thread per row, a loop over the m columns held in registers.
// There is no padding: the grid covers ceil(rows / 128) blocks and the
// ragged last block masks itself.  A row is m*4 bytes, so neighbouring
// threads read neighbouring rows and a warp's loads share cache lines.
// Warp-per-row-group layouts, TMA and wgmma are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's mask value

__global__ void row_top2_regret_kernel(const float* __restrict__ proto,
                                       int32_t* __restrict__ best,
                                       int32_t* __restrict__ second,
                                       float* __restrict__ regret,
                                       int64_t rows, int m) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = proto + r * m;

  float best_val = p[0];
  int best_idx = 0;
  for (int j = 1; j < m; ++j) {
    const float v = p[j];
    if (v > best_val) {
      best_val = v;
      best_idx = j;
    }
  }

  float second_val = best_idx == 0 ? kNegInf : p[0];
  int second_idx = 0;
  for (int j = 1; j < m; ++j) {
    const float v = j == best_idx ? kNegInf : p[j];
    if (v > second_val) {
      second_val = v;
      second_idx = j;
    }
  }

  best[r] = best_idx;
  second[r] = second_idx;
  regret[r] = 2.0f * (best_val - second_val);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  rows == 0 launches nothing.
extern "C" int knn_row_top2_regret(const float* proto, int32_t* best,
                                   int32_t* second, float* regret,
                                   int64_t rows, int m, cudaStream_t stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  row_top2_regret_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(proto, best, second, regret, rows, m);
  return static_cast<int>(cudaGetLastError());
}
