// K1: the generator's synthesis conv, forward.
//
//   out = gamma * (hv - mean) * rsqrt(var + eps) + beta,
//   hv  = LeakyReLU_0.2(conv3x3_pad1(x, w) + bias + noise * noise_w)
//
// with mean and the biased var taken per (sample, channel) over all H*W
// pixels.  x (N,H,W,Cin) and w (3,3,Cin,Cout, already equalized-scaled) are
// f32 or bf16; bias and noise_w f32; noise (N,H,W,1), gamma and beta (N,Cout)
// in x's dtype; out in x's dtype.  Accumulation is f32 throughout.
//
// Replaces byogan_tpu/ops/pallas_styleconv.py::_kernel (46-95), reached
// through _call_kernel (149-208) and styleconv_pallas (211-227).  The TPU
// kernel keeps whole samples in VMEM (_pick_nb) and takes one-pass
// sum / sum-of-squares statistics; neither carries over.
//
// What bounds it on the H100: the conv's multiply-adds.  At the path's
// shapes it does 2*H*W*9*Cin*Cout flops per sample (21.3 GFLOP per 512 px
// image) against at most a few bytes per flop moved, far above the card's
// balance point, so the bound is compute: 989 TFLOP/s on bf16 tensor cores.
// This first kernel runs on the CUDA cores (67 TFLOP/s in f32), so it sits
// well above that bound; wgmma and TMA are later work.
//
// Design:
//   * Pass 1 (conv3x3_epilogue): implicit GEMM with M = pixels of one
//     sample, N = Cout, K = 9*Cin.  A block computes a BM x BN tile with 256
//     threads, 4x4 outputs each, staging 16-deep slices of the zero-padded
//     input and of the weight in shared memory (bf16 converted to f32 on
//     load).  BN follows Cout (16, 32 or 64) so the narrow top stages waste
//     no lanes.  The epilogue adds bias and noise, applies LeakyReLU, writes
//     hv to an f32 scratch and, per column, the tile's mean and centred M2 --
//     partials in an (N, tiles, Cout) buffer instead of atomics, so the
//     result is the same on every run.  Statistics span all H*W of a sample
//     (262,144 pixels at 512 px), far more than a block, hence the passes.
//   * Pass 2a (finalize_moments, common.cuh): Chan's merge of the partials
//     into per-(sample, channel) scale and shift.  This deviates from the
//     TPU kernel's one-pass var = E[h^2] - mean^2: at this size the
//     cancellation would cost digits.
//   * Pass 2b (affine_apply): out = scale * hv + shift in the output dtype.
//
// Training: the TPU kernel's emit_hv variant (_call_kernel with
// emit_hv=True, reached from the custom_vjp's _styleconv_fwd) also writes hv
// as the backward's residual, in x's dtype.  Here hv is pass 1's f32
// scratch, handed to the caller as it is (more exact than a bf16 copy, and
// no extra write), and pass 2a also writes the per-(sample, channel) mean
// and inv = rsqrt(var + eps) when mean_out is not null, so the backward
// (K3, styleconv_bwd.cu) need not recompute them.  Inference passes null.
#include <cstdint>

#include "common.cuh"

namespace byogan {
namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;  // input channels per shared-memory slice
constexpr int TM = 4, TN = 4;

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    conv3x3_epilogue(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, const T* __restrict__ noise,
                     const float* __restrict__ noise_w, float* __restrict__ hv,
                     float* __restrict__ part_mean, float* __restrict__ part_m2,
                     int H, int W, int Cin, int Cout, int tiles) {
  constexpr int NTX = BN / TN;  // threads along output channels
  constexpr int NTY = BM / TM;  // threads along pixels
  static_assert(NTX * NTY == kThreads, "one 4x4 micro-tile per thread");
  constexpr int A_ROWS = kThreads / BK;      // pixel rows loaded per pass
  constexpr int A_ITERS = BM / A_ROWS;
  constexpr int B_ITERS = BK * BN / kThreads;
  static_assert(B_ITERS >= 1, "BN >= 16");

  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ float red[NTY][BN];
  __shared__ float col_mean[BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int tile = blockIdx.x, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int HW = H * W;
  const int p0 = tile * BM;
  const int rows = min(BM, HW - p0);
  const T* xs = x + (long long)s * HW * Cin;

  // Pixel coordinates of the A rows this thread loads (-H marks "no pixel").
  const int ak = tid % BK;
  int ay[A_ITERS], ax[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int m = tid / BK + i * A_ROWS;
    ay[i] = m < rows ? (p0 + m) / W : -H - 2;
    ax[i] = m < rows ? (p0 + m) % W : 0;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const T* wt = w + (long long)tap * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + ak;
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int yy = ay[i] + dy, xx = ax[i] + dx;
        float v = 0.f;
        if (ci < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = to_f<T>(xs[((long long)yy * W + xx) * Cin + ci]);
        As[ak][tid / BK + i * A_ROWS] = v;
      }
#pragma unroll
      for (int i = 0; i < B_ITERS; ++i) {
        const int e = tid + i * kThreads;
        const int bk = e / BN, bn = e % BN;
        const int cj = c0 + bk, co = n0 + bn;
        Bs[bk][bn] = (cj < Cin && co < Cout) ? to_f<T>(wt[(long long)cj * Cout + co]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * NTY];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * NTX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Epilogue: bias + noise, LeakyReLU as max(h, 0.2h), hv to scratch.
  float bv[TN], nwv[TN], colsum[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int co = n0 + tx + j * NTX;
    bv[j] = co < Cout ? bias[co] : 0.f;
    nwv[j] = co < Cout ? noise_w[co] : 0.f;
    colsum[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = ty + i * NTY;
    if (m < rows) {
      const long long pix = (long long)s * HW + p0 + m;
      const float nz = to_f<T>(noise[pix]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float v = acc[i][j] + bv[j] + nwv[j] * nz;
        v = fmaxf(v, 0.2f * v);
        acc[i][j] = v;
        colsum[j] += v;
        const int co = n0 + tx + j * NTX;
        if (co < Cout) hv[pix * Cout + co] = v;
      }
    }
  }

  // Per-column tile mean, then centred M2, reduced over the tile's rows in a
  // fixed order.
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * NTX] = colsum[j];
  __syncthreads();
  if (tid < BN) {
    float sum = 0.f;
    for (int r = 0; r < NTY; ++r) sum += red[r][tid];
    col_mean[tid] = sum / (float)rows;
  }
  __syncthreads();
  float colm2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float mu = col_mean[tx + j * NTX];
    colm2[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (ty + i * NTY < rows) {
        const float d = acc[i][j] - mu;
        colm2[j] += d * d;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * NTX] = colm2[j];
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    float q = 0.f;
    for (int r = 0; r < NTY; ++r) q += red[r][tid];
    const long long idx = ((long long)s * tiles + tile) * Cout + n0 + tid;
    part_mean[idx] = col_mean[tid];
    part_m2[idx] = q;
  }
}

// out[s, p, c] = scale[s, c] * hv[s, p, c] + shift[s, c], in T.
template <typename T>
__global__ void affine_apply(const float* __restrict__ hv,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift, T* __restrict__ out,
                             int total, int hwc, int C) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int sc = (i / hwc) * C + i % C;
    out[i] = from_f<T>(fmaf(scale[sc], hv[i], shift[sc]));
  }
}

template <typename T, int BM, int BN>
void launch_conv(const void* x, const void* w, const float* bias,
                 const void* noise, const float* nw, float* hv, float* pm,
                 float* pm2, int n, int h, int wd, int cin, int cout, int tiles,
                 cudaStream_t stream) {
  const dim3 grid(tiles, (cout + BN - 1) / BN, n);
  conv3x3_epilogue<T, BM, BN><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, bias, (const T*)noise, nw, hv, pm, pm2, h, wd,
      cin, cout, tiles);
}

template <typename T>
int run(const void* x, const void* w, const float* bias, const void* noise,
        const float* nw, const void* gamma, const void* beta, void* out,
        float* hv, float* pm, float* pm2, float* scale_shift, float* mean_out,
        float* inv_out, int n, int h, int wd, int cin, int cout, int block_m,
        float eps, cudaStream_t stream) {
  const int hw = h * wd;
  const int tiles = (hw + block_m - 1) / block_m;
  switch (block_m) {  // BM x BN = 64x64, 128x32 or 256x16 (see styleconv.py)
    case 64:
      launch_conv<T, 64, 64>(x, w, bias, noise, nw, hv, pm, pm2, n, h, wd, cin,
                             cout, tiles, stream);
      break;
    case 128:
      launch_conv<T, 128, 32>(x, w, bias, noise, nw, hv, pm, pm2, n, h, wd,
                              cin, cout, tiles, stream);
      break;
    case 256:
      launch_conv<T, 256, 16>(x, w, bias, noise, nw, hv, pm, pm2, n, h, wd,
                              cin, cout, tiles, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  float* scale = scale_shift;
  float* shift = scale_shift + (long long)n * cout;
  finalize_moments<T><<<dim3(cout, n), finalize_threads(tiles), 0, stream>>>(
      pm, pm2, (const T*)gamma, (const T*)beta, scale, shift, mean_out,
      inv_out, tiles, block_m, hw, cout, eps);
  const int total = n * hw * cout;
  affine_apply<T><<<grid_for(total, 256), 256, 0, stream>>>(
      hv, scale, shift, (T*)out, total, hw * cout, cout);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace byogan

extern "C" int styleconv_forward(const void* x, const void* w, const void* bias,
                                 const void* noise, const void* noise_w,
                                 const void* gamma, const void* beta, void* out,
                                 void* hv, void* part_mean, void* part_m2,
                                 void* scale_shift, void* mean_out,
                                 void* inv_out, int n, int h, int w_, int cin,
                                 int cout, int block_m, float eps, int dtype,
                                 void* stream) {
  using namespace byogan;
  auto st = (cudaStream_t)stream;
  auto b = (const float*)bias;
  auto nw = (const float*)noise_w;
  auto f = [](void* p) { return (float*)p; };
  if (dtype == kFloat32)
    return run<float>(x, w, b, noise, nw, gamma, beta, out, f(hv),
                      f(part_mean), f(part_m2), f(scale_shift), f(mean_out),
                      f(inv_out), n, h, w_, cin, cout, block_m, eps, st);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(x, w, b, noise, nw, gamma, beta, out, f(hv),
                              f(part_mean), f(part_m2), f(scale_shift),
                              f(mean_out), f(inv_out), n, h, w_, cin, cout,
                              block_m, eps, st);
  return (int)cudaErrorInvalidValue;
}
