// K3: the backward of the synthesis epilogue (noise -> LeakyReLU -> AdaIN).
//
// Given dy = dL/d(out) for out = gamma * hhat + beta, hhat = (hv - mean) * inv,
// hv = LeakyReLU_0.2(pre), pre = conv + bias + noise * noise_w:
//
//   dgamma[n,c]  = sum_hw dy * hhat            dbeta[n,c] = sum_hw dy
//   dhv          = inv * (g*dy - mean_hw(g*dy) - hhat * mean_hw(g*dy*hhat))
//   dpre         = dhv where hv >= 0, else 0.2 * dhv      (written in T)
//   dbias[c]     = sum_{n,hw} dpre             dnoise_w[c] = sum_{n,hw} dpre * noise
//   dnoise[n,hw] = sum_c dpre * noise_w
//
// with every sum in f32.  dy, gamma, noise, dpre, dnoise, dgamma and dbeta
// are T (f32 or bf16); hv (N,HW,C), mean and inv (N,C), noise_w, dbias and
// dnoise_w are f32.  Both synthesis-conv forwards (K1 and K2) write hv, mean
// and inv for it.
//
// Replaces the elementwise-and-reduction part of
// byogan_tpu/ops/pallas_styleconv.py::_styleconv_bwd (266-292), the backward
// of the styleconv custom_vjp; that is closed-form lax in JAX, left to XLA.
// The conv transposes that follow (296-304) stay with cuDNN in the wrapper.
//
// What bounds it on the H100: bytes.  About 20 flops per element against
// reading dy (T), hv (f32) and writing dpre (T): far below the card's
// balance point, so the bound is those bytes at 3.35 TB/s.
//
// Design: three reductions along three axes -- over H*W per (sample,
// channel), over N*H*W per channel, over C per pixel -- with no atomics and
// a fixed summation order, so the result is the same on every run.
//   * A block is 8 warps over kTile pixels of one sample; a warp walks one
//     pixel at a time with its 32 lanes over the channels (NHWC is
//     channel-minor, so each load is contiguous).  Per-channel running sums
//     live in shared memory, one row per warp, each slot owned by one lane.
//   * Pass A (tile_sums): per tile, S1 = sum dy and S2 = sum dy*hhat per
//     channel, the 8 warp rows added in order, to an (N, tiles, C) buffer.
//   * Pass B (sum_rows, common.cuh): S1 and S2 per (sample, channel).
//   * Pass C (apply): dpre per element; dnoise per pixel by a warp shuffle
//     tree over the lanes' channel sums; per-tile partials of dbias and
//     dnoise_w to the (now free) partials buffer.  Tile 0 of each sample
//     writes dgamma = S2 and dbeta = S1.
//   * Pass D (sum_rows): dbias and dnoise_w over all N*tiles partials.
#include "common.cuh"

namespace byogan {
namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps, kTile = 256;
constexpr int kMaxC = 512;  // shared-memory rows; the wrapper checks C

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tile_sums(const T* __restrict__ dy, const float* __restrict__ hv,
              const float* __restrict__ mean, const float* __restrict__ inv,
              float* __restrict__ part, int hw, int C, int tiles) {
  __shared__ float s1[kWarps][kMaxC], s2[kWarps][kMaxC];
  __shared__ float sm[kMaxC], si[kMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, s = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    sm[c] = mean[s * C + c];
    si[c] = inv[s * C + c];
  }
  for (int c = lane; c < C; c += 32) s1[warp][c] = s2[warp][c] = 0.f;
  __syncthreads();
  const int p1 = min((tile + 1) * kTile, hw);
  for (int p = tile * kTile + warp; p < p1; p += kWarps) {
    const long long base = ((long long)s * hw + p) * C;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f<T>(dy[base + c]);
      const float hh = (hv[base + c] - sm[c]) * si[c];
      s1[warp][c] += d;
      s2[warp][c] += d * hh;
    }
  }
  __syncthreads();
  const long long plane = (long long)gridDim.y * tiles * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += s1[w][c];
      b += s2[w][c];
    }
    const long long idx = ((long long)s * tiles + tile) * C + c;
    part[idx] = a;
    part[plane + idx] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply(const T* __restrict__ dy, const float* __restrict__ hv,
          const float* __restrict__ mean, const float* __restrict__ inv,
          const T* __restrict__ gamma, const T* __restrict__ noise,
          const float* __restrict__ noise_w, const float* __restrict__ sums,
          T* __restrict__ dpre, T* __restrict__ dnoise, T* __restrict__ dgamma,
          T* __restrict__ dbeta, float* __restrict__ part, int hw, int C,
          int tiles) {
  __shared__ float db[kWarps][kMaxC], dnw[kWarps][kMaxC];
  __shared__ float sm[kMaxC], si[kMaxC], sg[kMaxC], a1[kMaxC], a2[kMaxC],
      snw[kMaxC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, s = blockIdx.y, n = gridDim.y;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int sc = s * C + c;
    const float g = to_f<T>(gamma[sc]), S1 = sums[sc], S2 = sums[n * C + sc];
    sm[c] = mean[sc];
    si[c] = inv[sc];
    sg[c] = g;
    a1[c] = g * S1 / (float)hw;  // mean_hw(g * dy)
    a2[c] = g * S2 / (float)hw;  // mean_hw(g * dy * hhat)
    snw[c] = noise_w[c];
    if (tile == 0) {
      dgamma[sc] = from_f<T>(S2);
      dbeta[sc] = from_f<T>(S1);
    }
  }
  for (int c = lane; c < C; c += 32) db[warp][c] = dnw[warp][c] = 0.f;
  __syncthreads();
  const int p1 = min((tile + 1) * kTile, hw);
  for (int p = tile * kTile + warp; p < p1; p += kWarps) {
    const long long pix = (long long)s * hw + p, base = pix * C;
    const float nz = to_f<T>(noise[pix]);
    float dn = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float h = hv[base + c];
      const float hh = (h - sm[c]) * si[c];
      const float dhv =
          si[c] * (sg[c] * to_f<T>(dy[base + c]) - a1[c] - hh * a2[c]);
      const float dp = h >= 0.f ? dhv : 0.2f * dhv;
      dpre[base + c] = from_f<T>(dp);
      db[warp][c] += dp;
      dnw[warp][c] += dp * nz;
      dn += dp * snw[c];
    }
    for (int off = 16; off > 0; off >>= 1)
      dn += __shfl_down_sync(0xffffffffu, dn, off);
    if (lane == 0) dnoise[pix] = from_f<T>(dn);
  }
  __syncthreads();
  const long long plane = (long long)n * tiles * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += db[w][c];
      b += dnw[w][c];
    }
    const long long idx = ((long long)s * tiles + tile) * C + c;
    part[idx] = a;
    part[plane + idx] = b;
  }
}

template <typename T>
int run(const void* dy, const float* hv, const float* mean, const float* inv,
        const void* gamma, const void* noise, const float* nw, void* dpre,
        void* dnoise, void* dgamma, void* dbeta, float* dbias_dnw,
        float* part, float* sums, int n, int hw, int C, cudaStream_t stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  const int tiles = (hw + kTile - 1) / kTile;
  const dim3 grid(tiles, n);
  tile_sums<T><<<grid, kThreads, 0, stream>>>((const T*)dy, hv, mean, inv, part,
                                              hw, C, tiles);
  sum_rows<<<dim3(C, n, 2), 256, 0, stream>>>(part, sums, tiles, C);
  apply<T><<<grid, kThreads, 0, stream>>>(
      (const T*)dy, hv, mean, inv, (const T*)gamma, (const T*)noise, nw, sums,
      (T*)dpre, (T*)dnoise, (T*)dgamma, (T*)dbeta, part, hw, C, tiles);
  sum_rows<<<dim3(C, 1, 2), 256, 0, stream>>>(part, dbias_dnw, n * tiles, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace byogan

// dbias_dnw is (2, C) f32: dbias, then dnoise_w.  part is (2, N*tiles, C)
// f32 scratch, sums (2, N, C) f32 scratch (tiles = ceil(hw / 256)).
extern "C" int styleconv_backward(const void* dy, const void* hv,
                                  const void* mean, const void* inv,
                                  const void* gamma, const void* noise,
                                  const void* noise_w, void* dpre, void* dnoise,
                                  void* dgamma, void* dbeta, void* dbias_dnw,
                                  void* part, void* sums, int n, int hw, int c,
                                  int dtype, void* stream) {
  using namespace byogan;
  auto st = (cudaStream_t)stream;
  auto cf = [](const void* p) { return (const float*)p; };
  auto f = [](void* p) { return (float*)p; };
  if (dtype == kFloat32)
    return run<float>(dy, cf(hv), cf(mean), cf(inv), gamma, noise, cf(noise_w),
                      dpre, dnoise, dgamma, dbeta, f(dbias_dnw), f(part),
                      f(sums), n, hw, c, st);
  if (dtype == kBFloat16)
    return run<__nv_bfloat16>(dy, cf(hv), cf(mean), cf(inv), gamma, noise,
                              cf(noise_w), dpre, dnoise, dgamma, dbeta,
                              f(dbias_dnw), f(part), f(sums), n, hw, c, st);
  return (int)cudaErrorInvalidValue;
}
