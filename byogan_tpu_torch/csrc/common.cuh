// Device code shared by the styleconv (K1), AdaIN-epilogue (K2) and
// epilogue-backward (K3) kernels: dtype conversion, the deterministic merge
// of per-tile moments and the pass that turns merged moments into the
// per-(sample, channel) affine.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace byogan {

enum Dtype { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Round a float to T's precision and back: one arithmetic step in T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// Chan et al.'s merge of two (count, mean, M2) summaries into the first.
// Merging per-tile centred moments keeps the variance accurate at 262,144
// pixels per sample, where sum(x^2)/n - mean^2 loses digits to cancellation.
__device__ __forceinline__ void merge_moments(float& n, float& mean, float& m2,
                                              float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n / nn * nb);
  n = nn;
}

// How a sample's h x w pixels are cut into th x tw tiles, tiles_x to a row
// of the grid, numbered row by row.  A run of `tile` pixels of the flattened
// sample is {1, hw, 1, tile, tiles}; a tile of whole samples is {h, w, h, w, 1}.
struct TileGrid {
  int h, w, th, tw, tiles_x;
  __device__ __forceinline__ int count(int t) const {
    return min(th, h - (t / tiles_x) * th) * min(tw, w - (t % tiles_x) * tw);
  }
};

// One block per (channel c = blockIdx.x, sample s = blockIdx.y).  Merges the
// `tiles` partial (mean, M2) summaries of (s, c), tile t holding
// grid.count(t) pixels, in a fixed tree order (the same result on every
// run), then writes
//   scale = gamma * rsqrt(M2/hw + eps),  shift = beta - scale * mean,
// and, when mean_out is not null (a forward that feeds K3), the mean and
// inv = rsqrt(M2/hw + eps) themselves.  blockDim.x is a power of two <= 256.
template <typename T>
__global__ void finalize_moments(const float* __restrict__ part_mean,
                                 const float* __restrict__ part_m2,
                                 const T* __restrict__ gamma,
                                 const T* __restrict__ beta,
                                 float* __restrict__ scale,
                                 float* __restrict__ shift,
                                 float* __restrict__ mean_out,
                                 float* __restrict__ inv_out, int tiles,
                                 TileGrid grid, int C, float eps) {
  __shared__ float sn[256], sm[256], sq[256];
  const int c = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int hw = grid.h * grid.w;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int t = tid; t < tiles; t += blockDim.x) {
    const long long idx = ((long long)s * tiles + t) * C + c;
    merge_moments(n, mean, m2, (float)grid.count(t), part_mean[idx],
                  part_m2[idx]);
  }
  sn[tid] = n;
  sm[tid] = mean;
  sq[tid] = m2;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (tid < half)
      merge_moments(sn[tid], sm[tid], sq[tid], sn[tid + half], sm[tid + half],
                    sq[tid + half]);
    __syncthreads();
  }
  if (tid == 0) {
    const float inv = rsqrtf(sq[0] / (float)hw + eps);
    const float g = to_f<T>(gamma[s * C + c]) * inv;
    scale[s * C + c] = g;
    shift[s * C + c] = to_f<T>(beta[s * C + c]) - g * sm[0];
    if (mean_out) {
      mean_out[s * C + c] = sm[0];
      inv_out[s * C + c] = inv;
    }
  }
}

inline int finalize_threads(int tiles) {
  int t = 32;
  while (t < tiles && t < 256) t *= 2;
  return t;
}

inline int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // enough blocks to fill every SM
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace byogan

extern "C" const char* byogan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
