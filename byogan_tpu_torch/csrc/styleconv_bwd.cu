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
// What bounds it on the H100: bytes.  About 25 flops per element against
// reading dy (T) and hv (f32) and writing dpre (T): far below the card's
// balance point.  It needs the per-(sample, channel) sums before any dpre, so
// dy and hv are read twice (pass A, pass C); up to 128 px one call's dy and
// hv fit the 50 MB L2 and the second read hits it.
//
// Design: three reductions along three axes -- over H*W per (sample,
// channel), over N*H*W per channel, over C per pixel -- with no atomics and
// a fixed summation order, so the result is the same on every run.
//   * Layout.  A block is 256 threads; each thread owns kVec = 8 consecutive
//     channels of one pixel (G = ceil(C/8) threads a pixel, P = 256/G pixels
//     a step: 4 at C = 512, 128 at C = 16).  A thread's channel group stays
//     the same over the pixels it visits, so its per-channel sums build up
//     in registers.  The vector route (C % 8 == 0, dy, hv and dpre 16-byte
//     aligned) loads 8 channels of bf16 with one 16-byte load and of f32 with
//     two; the scalar route takes the same layout with element loads and a
//     ragged last group.  kUnroll steps' loads are issued before their
//     arithmetic; 1 measured fastest (tools/sweep_k3.py: 2 and 4 take more
//     registers and fewer blocks fit an SM), so a thread keeps its step's
//     three 16-byte loads in flight and the SM's other warps cover latency.
//   * Tile plan (ops/styleconv_bwd.py::plan_backward): a block takes `steps`
//     steps of one sample, `tiles` blocks a sample, so that a call has about
//     two blocks an SM where the work allows it: every step its own block at
//     small images, 10-40 steps a block at 256-512 px (not one block per
//     256 pixels), which keeps the partials small.
//   * Block merges (merge_groups): the threads that share a channel group add
//     their sums by warp shuffles where G is a power of two under 32, then
//     over warps (or over all sharing threads) in shared memory sized to the
//     block, in a fixed order.  dnoise per pixel: the pixel's G threads by a
//     shuffle tree over min(G, 32) lanes, then in shared memory across warps
//     (C = 512) or across threads (G not a power of two).
//   * Pass A (epilogue_sums): per block, S1 = sum dy and S2 = sum dy*hhat per
//     channel to an (N, tiles, C) partials buffer.
//   * Pass B (sum_tiles): S1 and S2 per (sample, channel).
//   * Pass C (epilogue_apply): dpre and dnoise; per-block partials of dbias
//     and dnoise_w to the (now free) partials buffer.  The first block of
//     each sample writes dgamma = S2 and dbeta = S1.
//   * Pass D (sum_tiles): dbias and dnoise_w over all N*tiles partials.
//   sum_tiles reads the partials a row of channels at a time (coalesced),
//   its 256 threads split over the rows, and adds them by a fixed tree.
#include "common.cuh"

namespace byogan {
namespace {

constexpr int kThreads = 256, kUnroll = 1;
constexpr int kMergeThreads = 256;

// The block's share of the work: G threads a pixel, P pixels a step, `steps`
// steps a block, `tiles` blocks a sample.
struct Plan {
  int groups, pixels, steps, tiles;
};

__device__ __forceinline__ bool pow2(int x) { return (x & (x - 1)) == 0; }

// Adds a[] and b[] over the threads that share a channel group (thread t has
// group t % G; P pixels a step) in a fixed order and writes the block's sums
// to out_a[c] and out_b[c], c < C.  Where G is a power of two under 32, a
// warp's lanes of one group are first added by a shuffle tree, so each warp
// leaves one sum per group (at lane g); then the 8 warps' (or, otherwise,
// the P sharing threads') values are added in shared memory.
__device__ __forceinline__ void merge_groups(float (&a)[kVec], float (&b)[kVec],
                                             float (*red)[kVec][kThreads],
                                             int G, int P, int C,
                                             float* __restrict__ out_a,
                                             float* __restrict__ out_b) {
  const int t = threadIdx.x;
  const bool shfl = G < 32 && pow2(G);
  if (shfl) {
    for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        a[v] += __shfl_xor_sync(0xffffffffu, a[v], off);
        b[v] += __shfl_xor_sync(0xffffffffu, b[v], off);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    red[0][v][t] = a[v];
    red[1][v][t] = b[v];
  }
  __syncthreads();
  const int rows = shfl ? kThreads / 32 : P, stride = shfl ? 32 : G;
  for (int o = t; o < 2 * kVec * G; o += kThreads) {
    const int k = o / (kVec * G), v = (o / G) % kVec, g = o % G;
    const int c = g * kVec + v;
    if (c >= C) continue;
    float acc = 0.f;
    for (int i = 0; i < rows; ++i) acc += red[k][v][i * stride + g];
    (k ? out_b : out_a)[c] = acc;
  }
}

// Pass A.  Block (tile, s): pixels [tile*steps*P, (tile+1)*steps*P) of
// sample s.  part[k, s, tile, c]: k = 0 S1, k = 1 S2.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
    epilogue_sums(const T* __restrict__ dy, const float* __restrict__ hv,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  float* __restrict__ part, int hw, int C, Plan pl) {
  __shared__ float red[2][kVec][kThreads];
  const int t = threadIdx.x, tile = blockIdx.x, s = blockIdx.y;
  const int g = t % pl.groups, q = t / pl.groups;
  const int c0 = g * kVec, nc = min(kVec, C - c0);
  const bool active = q < pl.pixels;
  float m[kVec], iv[kVec], s1[kVec], s2[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    m[v] = v < nc ? mean[s * C + c0 + v] : 0.f;
    iv[v] = v < nc ? inv[s * C + c0 + v] : 0.f;
    s1[v] = s2[v] = 0.f;
  }
  const int span = pl.steps * pl.pixels;
  const int p0 = tile * span + q, p_end = min((tile + 1) * span, hw);
  const long long row0 = (long long)s * hw;
  for (int st = 0; st < pl.steps; st += kUnroll) {
    float d[kUnroll][kVec], h[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + (st + u) * pl.pixels;
      if (active && p < p_end) {
        const long long off = (row0 + p) * C + c0;
        load8<Vec>(dy + off, nc, d[u]);
        load8<Vec>(hv + off, nc, h[u]);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) d[u][v] = h[u][v] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        s1[v] += d[u][v];
        s2[v] += d[u][v] * ((h[u][v] - m[v]) * iv[v]);
      }
    }
  }
  const long long idx = ((long long)s * pl.tiles + tile) * C;
  const long long plane = (long long)gridDim.y * pl.tiles * C;
  merge_groups(s1, s2, red, pl.groups, pl.pixels, C, part + idx,
               part + plane + idx);
}

// Pass C.  sums[k, s, c] from pass B (k = 0 S1, k = 1 S2); part[k, s, tile,
// c]: k = 0 dbias, k = 1 dnoise_w, per block.
template <typename T, bool Vec>
__global__ void __launch_bounds__(kThreads)
    epilogue_apply(const T* __restrict__ dy, const float* __restrict__ hv,
                   const float* __restrict__ mean,
                   const float* __restrict__ inv, const T* __restrict__ gamma,
                   const T* __restrict__ noise,
                   const float* __restrict__ noise_w,
                   const float* __restrict__ sums, T* __restrict__ dpre,
                   T* __restrict__ dnoise, T* __restrict__ dgamma,
                   T* __restrict__ dbeta, float* __restrict__ part, int hw,
                   int C, Plan pl) {
  __shared__ float red[2][kVec][kThreads];
  __shared__ float sdn[kUnroll][kThreads];
  const int t = threadIdx.x, tile = blockIdx.x, s = blockIdx.y, n = gridDim.y;
  const int G = pl.groups, g = t % G, q = t / G;
  const int c0 = g * kVec, nc = min(kVec, C - c0);
  const bool active = q < pl.pixels;
  // W lanes of a pixel are added by one shuffle tree, S such runs of lanes
  // in shared memory.
  const int W = pow2(G) ? min(G, 32) : 1, S = G / W;
  // dhv = inv * (g*dy - a1 - hhat * a2) with hhat = (hv - mean) * inv is
  // ka * dy + kb * hv + kc per channel: three registers a channel, not five.
  float ka[kVec], kb[kVec], kc[kVec], nw[kVec], db[kVec], dw[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    ka[v] = kb[v] = kc[v] = nw[v] = db[v] = dw[v] = 0.f;
    if (v < nc) {
      const int sc = s * C + c0 + v;
      const float S1 = sums[sc], S2 = sums[n * C + sc];
      const float iv = inv[sc], gm = to_f<T>(gamma[sc]);
      const float a1 = gm * S1 / (float)hw;  // mean_hw(g * dy)
      const float a2 = gm * S2 / (float)hw;  // mean_hw(g * dy * hhat)
      ka[v] = iv * gm;
      kb[v] = -iv * iv * a2;
      kc[v] = -iv * a1 - kb[v] * mean[sc];
      nw[v] = noise_w[c0 + v];
      if (tile == 0 && q == 0) {
        dgamma[sc] = from_f<T>(S2);
        dbeta[sc] = from_f<T>(S1);
      }
    }
  }
  const int span = pl.steps * pl.pixels;
  const int p0 = tile * span + q, p_end = min((tile + 1) * span, hw);
  const long long row0 = (long long)s * hw;
  for (int st = 0; st < pl.steps; st += kUnroll) {
    float d[kUnroll][kVec], h[kUnroll][kVec], nz[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + (st + u) * pl.pixels;
      ok[u] = active && p < p_end;
      if (ok[u]) {
        const long long off = (row0 + p) * C + c0;
        load8<Vec>(dy + off, nc, d[u]);
        load8<Vec>(hv + off, nc, h[u]);
        nz[u] = to_f<T>(noise[row0 + p]);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) d[u][v] = h[u][v] = 0.f;
        nz[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + (st + u) * pl.pixels;
      float dp[kVec], dn = 0.f;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float dhv = ka[v] * d[u][v] + (kb[v] * h[u][v] + kc[v]);
        dp[v] = ok[u] ? (h[u][v] >= 0.f ? dhv : 0.2f * dhv) : 0.f;
        db[v] += dp[v];
        dw[v] += dp[v] * nz[u];
        dn += dp[v] * nw[v];
      }
      if (ok[u]) store8<Vec>(dpre + (row0 + p) * C + c0, nc, dp);
      for (int off = W / 2; off > 0; off >>= 1)
        dn += __shfl_xor_sync(0xffffffffu, dn, off);
      if (S == 1) {
        if (ok[u] && g == 0) dnoise[row0 + p] = from_f<T>(dn);
      } else if (t % W == 0) {
        sdn[u][t / W] = dn;
      }
    }
    if (S > 1) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && g == 0) {
          float dn = 0.f;
          for (int i = 0; i < S; ++i) dn += sdn[u][q * S + i];
          dnoise[row0 + p0 + (st + u) * pl.pixels] = from_f<T>(dn);
        }
      }
      __syncthreads();
    }
  }
  const long long idx = ((long long)s * pl.tiles + tile) * C;
  const long long plane = (long long)n * pl.tiles * C;
  merge_groups(db, dw, red, G, pl.pixels, C, part + idx, part + plane + idx);
}

// Passes B and D: out[k, c] = sum over r < rows of part[k, r, c], k =
// blockIdx.y, for the cw channels of block x (cw a power of two <= 32).
// Thread (j, l) takes channel cw*x + l and the rows r = j mod js, js =
// kMergeThreads/cw; the js row sums of a channel are then added by a fixed
// tree over j.
__global__ void __launch_bounds__(kMergeThreads)
    sum_tiles(const float* __restrict__ part, float* __restrict__ out,
              int rows, int C, int cw) {
  __shared__ float red[kMergeThreads];
  const int t = threadIdx.x, l = t % cw, j = t / cw, js = kMergeThreads / cw;
  const int c = blockIdx.x * cw + l;
  const float* src = part + (long long)blockIdx.y * rows * C + c;
  float acc = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int r = j; r < rows; r += js) acc += src[(long long)r * C];
  }
  red[t] = acc;
  __syncthreads();
  for (int half = js / 2; half > 0; half >>= 1) {
    if (j < half) red[t] += red[t + half * cw];
    __syncthreads();
  }
  if (j == 0 && c < C) out[(long long)blockIdx.y * C + c] = red[t];
}

template <typename T, bool Vec>
void run(const void* dy, const float* hv, const float* mean, const float* inv,
         const void* gamma, const void* noise, const float* nw, void* dpre,
         void* dnoise, void* dgamma, void* dbeta, float* dbias_dnw,
         float* scratch, int n, int hw, int C, Plan pl, cudaStream_t stream) {
  float* sums = scratch;              // (2, N, C)
  float* part = scratch + 2 * n * C;  // (2, N, tiles, C)
  const dim3 grid(pl.tiles, n);
  int cw = 1;
  while (cw < C && cw < 32) cw *= 2;
  const int cblocks = (C + cw - 1) / cw;
  epilogue_sums<T, Vec><<<grid, kThreads, 0, stream>>>(
      (const T*)dy, hv, mean, inv, part, hw, C, pl);
  sum_tiles<<<dim3(cblocks, 2 * n), kMergeThreads, 0, stream>>>(
      part, sums, pl.tiles, C, cw);
  epilogue_apply<T, Vec><<<grid, kThreads, 0, stream>>>(
      (const T*)dy, hv, mean, inv, (const T*)gamma, (const T*)noise, nw, sums,
      (T*)dpre, (T*)dnoise, (T*)dgamma, (T*)dbeta, part, hw, C, pl);
  sum_tiles<<<dim3(cblocks, 2), kMergeThreads, 0, stream>>>(
      part, dbias_dnw, n * pl.tiles, C, cw);
}

template <typename T>
int launch(bool vec, const void* dy, const float* hv, const float* mean,
           const float* inv, const void* gamma, const void* noise,
           const float* nw, void* dpre, void* dnoise, void* dgamma,
           void* dbeta, float* dbias_dnw, float* scratch, int n, int hw, int C,
           Plan pl, cudaStream_t stream) {
  if (vec)
    run<T, true>(dy, hv, mean, inv, gamma, noise, nw, dpre, dnoise, dgamma,
                 dbeta, dbias_dnw, scratch, n, hw, C, pl, stream);
  else
    run<T, false>(dy, hv, mean, inv, gamma, noise, nw, dpre, dnoise, dgamma,
                  dbeta, dbias_dnw, scratch, n, hw, C, pl, stream);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace byogan

// dbias_dnw is (2, C) f32: dbias, then dnoise_w.  scratch is f32: (2, N, C)
// sums, then (2, N, tiles, C) partials.  The plan (groups, pixels, steps,
// tiles) is ops/styleconv_bwd.py::plan_backward's; vec asks for the vector
// route, which needs C % 8 == 0 and dy, hv and dpre 16-byte aligned.
extern "C" int styleconv_backward(const void* dy, const void* hv,
                                  const void* mean, const void* inv,
                                  const void* gamma, const void* noise,
                                  const void* noise_w, void* dpre, void* dnoise,
                                  void* dgamma, void* dbeta, void* dbias_dnw,
                                  void* scratch, int n, int hw, int c,
                                  int groups, int pixels, int steps, int tiles,
                                  int vec, int dtype, void* stream) {
  using namespace byogan;
  const Plan pl{groups, pixels, steps, tiles};
  const long long span = (long long)steps * pixels;
  if (n < 1 || hw < 1 || c < 1 || groups != (c + kVec - 1) / kVec ||
      groups > kThreads || pixels != kThreads / groups || steps < 1 ||
      tiles < 1 || span * tiles < hw || span * (tiles - 1) >= hw)
    return (int)cudaErrorInvalidValue;
  if (vec && (c % kVec || !aligned16(dy) || !aligned16(hv) || !aligned16(dpre)))
    return (int)cudaErrorMisalignedAddress;
  auto st = (cudaStream_t)stream;
  auto cf = [](const void* p) { return (const float*)p; };
  auto f = [](void* p) { return (float*)p; };
  if (dtype == kFloat32)
    return launch<float>(vec, dy, cf(hv), cf(mean), cf(inv), gamma, noise,
                         cf(noise_w), dpre, dnoise, dgamma, dbeta,
                         f(dbias_dnw), f(scratch), n, hw, c, pl, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(vec, dy, cf(hv), cf(mean), cf(inv), gamma,
                                 noise, cf(noise_w), dpre, dnoise, dgamma,
                                 dbeta, f(dbias_dnw), f(scratch), n, hw, c,
                                 pl, st);
  return (int)cudaErrorInvalidValue;
}
