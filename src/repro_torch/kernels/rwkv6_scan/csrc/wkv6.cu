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
// S_T float32 [B, H, hd, hd], both contiguous.  The loop runs over every
// t: there is no chunk, so nothing is dropped for a ragged T (the chunk of
// the Pallas kernel was a VMEM blocking and changes nothing in the math).
//
// Bound on an H100: at the rwkv6-7b prefill shape (B=4, T=2048, H=64,
// hd=64, bf16 r/k/v) the function needs 5 float32 operations per state
// element and step: the bonus is an O(hd) term per step,
//   out_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i],
// so an FMA for the output and a product and an FMA for the state.  That
// is 10.7 GFLOP, 0.16 ms at 67 TFLOP/s on the CUDA cores, against 0.14 ms
// for the 470 MB of inputs and outputs; the T dependent steps add a
// latency floor of T times one FMA chain.  At the decode shape (T=1) it
// is bytes: reading and writing the 8.4 MB of state dominates.
//
// Design: one CTA of hd threads per (b, h); thread j keeps column S[:, j]
// in registers for the whole sequence, so the state never leaves the chip
// between steps.  The CTA stages a chunk of C steps of w, r, k and v in
// shared memory with coalesced loads (thread j loads element j of every
// row), forms each step's bonus sum_i r_i u_i k_i once for the CTA, syncs,
// and runs the C steps reading w_t, r_t, k_t as broadcasts.  Only B*H CTAs
// run (256 at the 7B shapes, two per SM), so the card is latency bound:
// splitting the i sum over more threads per column is the redesign.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  int64_t b, t, h;                          // element strides; last axis is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ w, const T* __restrict__ r,
            const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_out,
            Strides sw, Strides sr, Strides sk, Strides sv, int T_, int H) {
  constexpr int C = HD <= 64 ? 32 : 16;     // steps staged per sync
  __shared__ float ws[C][HD], rs[C][HD], ks[C][HD], vs[C][HD];
  __shared__ float ruk[HD][C + 1];          // r_i u_i k_i, padded: no bank conflicts
  __shared__ float bonus[C];                // sum_i r_i u_i k_i per step

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const float uj = u[h * HD + j];

  float S[HD];
  const int64_t s_base = static_cast<int64_t>(bh) * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0 ? s0[s_base + i * HD + j] : 0.f;

  const float* wb = w + b * sw.b + h * sw.h;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  // out is contiguous [B, T, H, HD]
  float* ob = out + (static_cast<int64_t>(b) * T_ * H + h) * HD + j;
  const int64_t o_t = static_cast<int64_t>(H) * HD;

  for (int t0 = 0; t0 < T_; t0 += C) {
    const int n = min(C, T_ - t0);
    __syncthreads();                        // the last chunk's readers are done
    for (int c = 0; c < n; ++c) {
      const int64_t t = t0 + c;
      const float rj = to_f32(rb[t * sr.t + j]), kj = to_f32(kb[t * sk.t + j]);
      ws[c][j] = wb[t * sw.t + j];
      rs[c][j] = rj;
      ks[c][j] = kj;
      vs[c][j] = to_f32(vb[t * sv.t + j]);
      ruk[j][c] = rj * uj * kj;
    }
    __syncthreads();
    for (int c = j; c < n; c += HD) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) sum += ruk[i][c];
      bonus[c] = sum;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = bonus[c] * vj;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        acc = fmaf(rs[c][i], S[i], acc);
        S[i] = fmaf(ws[c][i], S[i], ks[c][i] * vj);
      }
      ob[(t0 + c) * o_t] = acc;
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[s_base + i * HD + j] = S[i];
}

template <typename T, int HD>
cudaError_t launch(const float* w, const void* r, const void* k, const void* v,
                   const float* u, const float* s0, float* out, float* s_out,
                   const Strides* st, int B, int T_, int H, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      w, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), u, s0, out, s_out, st[0], st[1], st[2], st[3],
      T_, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const float* w, const void* r, const void* k,
                        const void* v, const float* u, const float* s0,
                        float* out, float* s_out, const Strides* st, int B,
                        int T_, int H, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, stream);
    case 16: return launch<T, 16>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, stream);
    case 32: return launch<T, 32>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, stream);
    case 64: return launch<T, 64>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, stream);
    case 128: return launch<T, 128>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  dtype (of r, k, v): 0 float32, 1 bfloat16.  strides: 12
// element strides, (b, t, h) of w, r, k and v in that order.  s0 may be
// null (zero state).  B*H == 0 launches nothing.
extern "C" int wkv6_fwd(const float* w, const void* r, const void* k,
                        const void* v, const float* u, const float* s0,
                        float* out, float* s_out, int dtype, int B, int T_,
                        int H, int hd, const int64_t* strides,
                        cudaStream_t stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(w, r, k, v, u, s0, out, s_out, st, B, T_, H, hd, stream);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(w, r, k, v, u, s0, out, s_out, st, B, T_, H,
                                     hd, stream);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
