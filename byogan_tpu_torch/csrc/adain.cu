// K2: the synthesis epilogue without the conv, forward.
//
//   h   = LeakyReLU_0.2(x + noise * noise_w)      (rounded as T arithmetic)
//   out = gamma * (h - mean) * rsqrt(var + eps) + beta
//
// with mean and the biased var in f32 per (sample, channel) over H*W.
// x (N,H,W,C), noise (N,H,W,1), gamma and beta (N,C) and out share one dtype
// T (f32 or bf16); noise_w is f32 and, as in the TPU kernel, cast to T first.
//
// Replaces byogan_tpu/ops/pallas_adain.py::_kernel (25-52), reached through
// noise_lrelu_adain_pallas (55-96).  The TPU kernel stages one whole sample
// in VMEM and takes one-pass sum / sum-of-squares statistics.
//
// What bounds it on the H100: bytes, in principle.  About 10 flops per
// element against 2 bytes in and 2 out (bf16): far below the card's balance
// point.  On the path it runs only at the initial 4x4 block (N = 1-24,
// C = 512), where the bytes take 0.1 us and the launch itself sets the time.
//
// Design of the path's route (H*W <= kOneTile), one launch, nothing but the
// outputs in device memory:
//   * Each thread owns kVec = 8 consecutive channels of up to kMaxPix pixels
//     of one sample: one 16-byte load of bf16 x a pixel (two in f32), one
//     16-byte store of out (two in f32) and, for training, two of the f32 hv
//     residual.  P = the next power of two >= H*W (at most 32) threads share
//     a channel group; they sit on P neighbouring lanes of one warp.
//   * The sample's h stays in registers, so the statistics take two passes
//     over registers, not memory: the sum, then the centred sum of squares
//     (the plain version's two-pass variance).  Each is merged over the P
//     lanes by an xor-shuffle tree: a fixed order, the same bits every run.
//   * The vector route needs C % 8 == 0 and x, out and hv on 16 bytes; the
//     element route (C % 8 != 0, unaligned views) takes the same layout with
//     element accesses and a ragged last group.
// Larger images (off the path) keep the split-HW scheme of K1's pass 2: per
// 256-pixel tile Welford partials (adain_partials), finalize_moments
// (common.cuh) merges them by Chan's formula, and adain_apply recomputes h
// from x (cheaper than a scratch round trip) and writes the affine.
//
// Training (the initial block's generator phase): when hv is not null the
// kernel also writes h in f32 (the backward's residual) and the
// per-(sample, channel) mean and inv = rsqrt(var + eps), which K3
// (styleconv_bwd.cu) takes.  The TPU kernel is forward-only; its JAX
// gradient is autodiff of the lax epilogue.
#include "common.cuh"

namespace byogan {
namespace {

constexpr int kOneTile = 256, kMaxPix = 8, kThreads = 128;
constexpr int kLanesC = 32, kLanesP = 8;  // the split-HW route's block

template <typename T>
__device__ __forceinline__ float lrelu_h(float x, float noise, float nw_t) {
  const float h = round_to<T>(x + round_to<T>(nw_t * noise));
  return fmaxf(h, round_to<T>(0.2f * h));
}

template <typename T>
__device__ __forceinline__ float epilogue_h(const T* x, const T* noise,
                                            float nw_t, long long pix, int C,
                                            int c) {
  return lrelu_h<T>(to_f<T>(x[pix * C + c]), to_f<T>(noise[pix]), nw_t);
}

// Adds v over the P lanes of a channel group (P a power of two <= 32, the
// group on lanes aligned to P): every lane gets the sum.
__device__ __forceinline__ void group_sum(float (&v)[kVec], int P) {
  for (int off = P / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

// The path's route.  Block (blockIdx.x, s = blockIdx.y): kThreads / P
// channel groups of sample s; thread t takes pixels q, q + P, ... (q = t % P)
// of group blockIdx.x * (kThreads / P) + t / P.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
    adain_fused(const T* __restrict__ x, const T* __restrict__ noise,
                const float* __restrict__ noise_w, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ out,
                float* __restrict__ hv, float* __restrict__ mean_out,
                float* __restrict__ inv_out, int hw, int C, int P, float eps) {
  const int t = threadIdx.x, q = t % P, s = blockIdx.y;
  const int c0 = (blockIdx.x * (kThreads / P) + t / P) * kVec;
  const int nc = max(0, min(kVec, C - c0));  // 0: past C, still shuffles
  // Every load is issued here, before the first shuffle: one round trip to
  // memory on the critical path, not one before and one after the sums.
  float nw[kVec], g[kVec], b[kVec], h[kMaxPix][kVec], sum[kVec], m2[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int c = min(c0 + v, C - 1);  // lanes past C load and drop
    nw[v] = nc > 0 ? round_to<T>(noise_w[c]) : 0.f;
    g[v] = nc > 0 ? to_f<T>(gamma[s * C + c]) : 0.f;
    b[v] = nc > 0 ? to_f<T>(beta[s * C + c]) : 0.f;
    sum[v] = m2[v] = 0.f;
  }
  const long long row0 = (long long)s * hw;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = q + k * P;
    if (nc > 0 && p < hw) {
      float xv[kVec];
      load8<Vec>(x + (row0 + p) * C + c0, nc, xv);
      const float nz = to_f<T>(noise[row0 + p]);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        h[k][v] = lrelu_h<T>(xv[v], nz, nw[v]);
        sum[v] += h[k][v];
      }
    }
  }
  group_sum(sum, P);
  const float rn = 1.f / (float)hw;
  float mean[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) mean[v] = sum[v] * rn;
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    if (nc > 0 && q + k * P < hw) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float d = h[k][v] - mean[v];
        m2[v] += d * d;
      }
    }
  }
  group_sum(m2, P);
  if (nc == 0) return;  // after the last shuffle
  float scale[kVec], shift[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const float inv = rsqrtf(m2[v] * rn + eps);
    scale[v] = g[v] * inv;
    shift[v] = b[v] - scale[v] * mean[v];
    if (hv && q == 0 && v < nc) {
      mean_out[s * C + c0 + v] = mean[v];
      inv_out[s * C + c0 + v] = inv;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = q + k * P;
    if (p < hw) {
      const long long off = (row0 + p) * C + c0;
      float o[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) o[v] = fmaf(scale[v], h[k][v], shift[v]);
      store8<Vec>(out + off, nc, o);
      if (hv) store8<Vec>(hv + off, nc, h[k]);
    }
  }
}

// Split HW: block (tile, channel block, s) summarises kOneTile pixels of 32
// channels as Welford (mean, M2), merged over its 8 pixel lanes in a fixed
// order, into the (N, tiles, C) partials.
template <typename T>
__global__ void __launch_bounds__(kLanesC * kLanesP)
    adain_partials(const T* __restrict__ x, const T* __restrict__ noise,
                   const float* __restrict__ noise_w,
                   float* __restrict__ part_mean, float* __restrict__ part_m2,
                   int hw, int C) {
  __shared__ float sn[kLanesP][kLanesC], sm[kLanesP][kLanesC],
      sq[kLanesP][kLanesC];
  const int lc = threadIdx.x, lp = threadIdx.y;
  const int tile = blockIdx.x, c = blockIdx.y * kLanesC + lc, s = blockIdx.z;
  const int p0 = tile * kOneTile, p1 = min(p0 + kOneTile, hw);
  const bool live = c < C;
  const float nw_t = live ? round_to<T>(noise_w[c]) : 0.f;

  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (live) {
    for (int p = p0 + lp; p < p1; p += kLanesP) {
      const float v = epilogue_h<T>(x, noise, nw_t, (long long)s * hw + p, C, c);
      n += 1.f;
      const float d = v - mean;
      mean += d / n;
      m2 += d * (v - mean);
    }
  }
  sn[lp][lc] = n;
  sm[lp][lc] = mean;
  sq[lp][lc] = m2;
  __syncthreads();
  for (int half = kLanesP / 2; half > 0; half >>= 1) {
    if (lp < half)
      merge_moments(sn[lp][lc], sm[lp][lc], sq[lp][lc], sn[lp + half][lc],
                    sm[lp + half][lc], sq[lp + half][lc]);
    __syncthreads();
  }
  if (lp == 0 && live) {
    const long long idx = ((long long)s * gridDim.x + tile) * C + c;
    part_mean[idx] = sm[0][lc];
    part_m2[idx] = sq[0][lc];
  }
}

template <typename T>
__global__ void adain_apply(const T* __restrict__ x, const T* __restrict__ noise,
                            const float* __restrict__ noise_w,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift, T* __restrict__ out,
                            float* __restrict__ hv, int total, int hw, int C) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int c = i % C, pix = i / C, sc = (pix / hw) * C + c;
    const float v = epilogue_h<T>(x, noise, round_to<T>(noise_w[c]), pix, C, c);
    out[i] = from_f<T>(fmaf(scale[sc], v, shift[sc]));
    if (hv) hv[i] = v;
  }
}

int lanes_for(int hw) {
  int p = 1;
  while (p < hw && p < 32) p *= 2;
  return p;
}

template <typename T>
int run(bool vec, const void* x, const void* noise, const float* nw,
        const void* gamma, const void* beta, void* out, float* hv,
        float* mean_out, float* inv_out, float* pm, float* pm2,
        float* scale_shift, int n, int hw, int C, float eps,
        cudaStream_t stream) {
  if (hw <= kOneTile) {
    const int P = lanes_for(hw), groups = (C + kVec - 1) / kVec;
    const int per_block = kThreads / P;
    const dim3 grid((groups + per_block - 1) / per_block, n);
    auto kernel = vec ? adain_fused<T, true> : adain_fused<T, false>;
    kernel<<<grid, kThreads, 0, stream>>>(
        (const T*)x, (const T*)noise, nw, (const T*)gamma, (const T*)beta,
        (T*)out, hv, mean_out, inv_out, hw, C, P, eps);
    return (int)cudaGetLastError();
  }
  const int tiles = (hw + kOneTile - 1) / kOneTile;
  const dim3 grid(tiles, (C + kLanesC - 1) / kLanesC, n);
  adain_partials<T><<<grid, dim3(kLanesC, kLanesP), 0, stream>>>(
      (const T*)x, (const T*)noise, nw, pm, pm2, hw, C);
  float* scale = scale_shift;
  float* shift = scale_shift + (long long)n * C;
  finalize_moments<T><<<dim3(C, n), finalize_threads(tiles), 0, stream>>>(
      pm, pm2, (const T*)gamma, (const T*)beta, scale, shift, mean_out, inv_out,
      tiles, TileGrid{1, hw, 1, kOneTile, tiles}, C, eps);
  const int total = n * hw * C;
  adain_apply<T><<<grid_for(total, 256), 256, 0, stream>>>(
      (const T*)x, (const T*)noise, nw, scale, shift, (T*)out, hv, total, hw, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace byogan

// hv, mean_out and inv_out are null for inference.  part_mean, part_m2 and
// scale_shift are the split-HW route's scratch, null for H*W <= 256.  vec
// asks for the one-tile route's vector accesses, which need C % 8 == 0 and
// x, out and hv 16-byte aligned.
extern "C" int adain_forward(const void* x, const void* noise,
                             const void* noise_w, const void* gamma,
                             const void* beta, void* out, void* hv,
                             void* mean_out, void* inv_out, void* part_mean,
                             void* part_m2, void* scale_shift, int n, int hw,
                             int c, float eps, int vec, int dtype,
                             void* stream) {
  using namespace byogan;
  if (vec && (c % kVec || !aligned16(x) || !aligned16(out) || (hv && !aligned16(hv))))
    return (int)cudaErrorInvalidValue;
  if (hw > kOneTile && !(part_mean && part_m2 && scale_shift))
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  auto nw = (const float*)noise_w;
  auto f = [](void* p) { return (float*)p; };
  if (dtype == kFloat32)
    return run<float>(vec, x, noise, nw, gamma, beta, out, f(hv), f(mean_out),
                      f(inv_out), f(part_mean), f(part_m2), f(scale_shift), n,
                      hw, c, eps, st);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(vec, x, noise, nw, gamma, beta, out, f(hv),
                              f(mean_out), f(inv_out), f(part_mean),
                              f(part_m2), f(scale_shift), n, hw, c, eps, st);
  return (int)cudaErrorInvalidValue;
}
