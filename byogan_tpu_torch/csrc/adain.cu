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
// What bounds it on the H100: bytes.  About 10 flops per element against 2
// bytes in and 2 out (bf16): far below the card's balance point, so the
// bound is reading x once and writing out once at 3.35 TB/s.
//
// Design: a block is 32 channels x 8 pixel lanes, so each warp reads 32
// neighbouring channels of one pixel (NHWC is channel-minor).  Each block
// covers up to kTile pixels of one sample and summarises them as (mean, M2)
// by Welford's update, merged across the 8 lanes in a fixed order.
//   * One tile per sample (H*W <= kTile, the path's 4x4 block): the block
//     holds the sample's whole statistics, so it applies the affine itself;
//     one launch in all.
//   * Otherwise the split-HW scheme of K1's pass 2: partials to an
//     (N, tiles, C) buffer, finalize_moments (common.cuh) merges them by
//     Chan's formula, and adain_apply recomputes h from x (cheaper than a
//     scratch round trip) and writes the affine.
//
// Training (the initial 4x4 block's generator phase): when hv is not null
// the kernel also writes h in f32 (the backward's residual) and the
// per-(sample, channel) mean and inv = rsqrt(var + eps), which K3
// (styleconv_bwd.cu) takes.  The TPU kernel is forward-only; its JAX
// gradient is autodiff of the lax epilogue.
#include "common.cuh"

namespace byogan {
namespace {

constexpr int kLanesC = 32, kLanesP = 8, kTile = 256;

template <typename T>
__device__ __forceinline__ float epilogue_h(const T* x, const T* noise,
                                            float nw_t, long long pix, int C,
                                            int c) {
  const float prod = round_to<T>(nw_t * to_f<T>(noise[pix]));
  const float h = round_to<T>(to_f<T>(x[pix * C + c]) + prod);
  return fmaxf(h, round_to<T>(0.2f * h));
}

template <typename T>
__global__ void __launch_bounds__(kLanesC * kLanesP)
    adain_tile(const T* __restrict__ x, const T* __restrict__ noise,
               const float* __restrict__ noise_w, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ out,
               float* __restrict__ hv, float* __restrict__ mean_out,
               float* __restrict__ inv_out, float* __restrict__ part_mean,
               float* __restrict__ part_m2, int hw, int C, float eps) {
  __shared__ float sn[kLanesP][kLanesC], sm[kLanesP][kLanesC],
      sq[kLanesP][kLanesC];
  __shared__ float s_scale[kLanesC], s_shift[kLanesC];
  const int lc = threadIdx.x, lp = threadIdx.y;
  const int tile = blockIdx.x, c = blockIdx.y * kLanesC + lc, s = blockIdx.z;
  const int p0 = tile * kTile, p1 = min(p0 + kTile, hw);
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
  if (gridDim.x > 1) {  // split HW: leave the merge to finalize_moments
    if (lp == 0 && live) {
      const long long idx = ((long long)s * gridDim.x + tile) * C + c;
      part_mean[idx] = sm[0][lc];
      part_m2[idx] = sq[0][lc];
    }
    return;
  }
  if (lp == 0 && live) {
    const float inv = rsqrtf(sq[0][lc] / (float)hw + eps);
    const float g = to_f<T>(gamma[s * C + c]) * inv;
    s_scale[lc] = g;
    s_shift[lc] = to_f<T>(beta[s * C + c]) - g * sm[0][lc];
    if (hv) {
      mean_out[s * C + c] = sm[0][lc];
      inv_out[s * C + c] = inv;
    }
  }
  __syncthreads();
  if (!live) return;
  for (int p = p0 + lp; p < p1; p += kLanesP) {
    const long long pix = (long long)s * hw + p;
    const float v = epilogue_h<T>(x, noise, nw_t, pix, C, c);
    out[pix * C + c] = from_f<T>(fmaf(s_scale[lc], v, s_shift[lc]));
    if (hv) hv[pix * C + c] = v;
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

template <typename T>
int run(const void* x, const void* noise, const float* nw, const void* gamma,
        const void* beta, void* out, float* hv, float* mean_out, float* inv_out,
        float* pm, float* pm2, float* scale_shift, int n, int hw, int C,
        float eps, cudaStream_t stream) {
  const int tiles = (hw + kTile - 1) / kTile;
  const dim3 grid(tiles, (C + kLanesC - 1) / kLanesC, n);
  adain_tile<T><<<grid, dim3(kLanesC, kLanesP), 0, stream>>>(
      (const T*)x, (const T*)noise, nw, (const T*)gamma, (const T*)beta,
      (T*)out, hv, mean_out, inv_out, pm, pm2, hw, C, eps);
  if (tiles > 1) {
    float* scale = scale_shift;
    float* shift = scale_shift + (long long)n * C;
    finalize_moments<T><<<dim3(C, n), finalize_threads(tiles), 0, stream>>>(
        pm, pm2, (const T*)gamma, (const T*)beta, scale, shift, mean_out,
        inv_out, tiles, kTile, hw, C, eps);
    const int total = n * hw * C;
    adain_apply<T><<<grid_for(total, 256), 256, 0, stream>>>(
        (const T*)x, (const T*)noise, nw, scale, shift, (T*)out, hv, total, hw,
        C);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace byogan

extern "C" int adain_forward(const void* x, const void* noise,
                             const void* noise_w, const void* gamma,
                             const void* beta, void* out, void* hv,
                             void* mean_out, void* inv_out, void* part_mean,
                             void* part_m2, void* scale_shift, int n, int hw,
                             int c, float eps, int dtype, void* stream) {
  using namespace byogan;
  auto st = (cudaStream_t)stream;
  auto nw = (const float*)noise_w;
  auto f = [](void* p) { return (float*)p; };
  if (dtype == kFloat32)
    return run<float>(x, noise, nw, gamma, beta, out, f(hv), f(mean_out),
                      f(inv_out), f(part_mean), f(part_m2), f(scale_shift), n,
                      hw, c, eps, st);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, noise, nw, gamma, beta, out, f(hv),
                              f(mean_out), f(inv_out), f(part_mean),
                              f(part_m2), f(scale_shift), n, hw, c, eps, st);
  return (int)cudaErrorInvalidValue;
}
