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
// kernel keeps nb whole samples in VMEM (_pick_nb), stages the zero-padded
// sample once for all 9 taps, and takes one-pass sum / sum-of-squares
// statistics.
//
// What bounds it on the H100.  The conv does 2*H*W*9*Cin*Cout flops per
// sample.  From 4 to 128 px the generator's channels are 512..64, so K =
// 9*Cin is 576..4608 and the bound is operations: 989 TFLOP/s on bf16
// tensor cores.  At 256 and 512 px (Cin 64..16, Cout 32..16) there are too
// few flops per byte and the bound is bytes: reading x once and writing out
// once at 3.35 TB/s.  The f32 hv scratch that the normalize pass re-reads
// (and that training keeps as K3's residual) adds to those bytes.
//
// Design of the bf16 route (the path users run: TrainConfig.compute_dtype,
// Sampler(dtype="bfloat16")):
//   * Pass 1 (conv3x3_mma): implicit GEMM with M = pixels, N = Cout, K =
//     9*Cin on the tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32, with
//     fragments read from shared memory by ldmatrix.  An output tile is BM
//     pixels: a th x tw rectangle of one sample, or spt whole samples where
//     H*W is smaller than the tile (the TPU kernel's nb).  For each slice of
//     BK input channels the block copies the (th+2) x (tw+2) x BK input
//     patch (zeros outside the image) and the 9 x BK x BN weight slice into
//     shared memory once, with 16-byte cp.async and zero-fill, and runs all
//     9 taps from it: each lane hands ldmatrix the address of its own pixel
//     row, so a tap's shifted window costs no copy.  A ring of kStages
//     buffers overlaps the copy of the next two slices with the math of
//     this one.  Halo and weight rows are padded by 16 bytes, so
//     ldmatrix's 8 row addresses fall in distinct banks.  The tile plan
//     comes from ops/styleconv.py::plan_tiles, its rules from the
//     measurements of ops/tile_sweep.py: BN follows Cout (16, 32, 64), BM
//     (16 to 256) is the largest that puts about one block on each of the
//     132 SMs at batch 8, two 8x8 samples share a tile of 128, BK is 16 so
//     that two or three blocks share an SM.  Every choice follows the
//     sample's shape alone, so a sample's rows sit on the same rows of any
//     tile that holds it: its moments are summed in the same order, and its
//     output has the same bits, whatever the batch (a tile of whole samples
//     may be partly empty).  What limits the 512-channel shapes now is the weight stream and
//     the ldmatrix traffic of mma.sync's small fragments: each block reads the
//     whole 9 x Cin x BN weight for its few rows (wgmma with TMA multicast
//     of the weight across a cluster is the next step).
//     The epilogue adds bias and noise, applies LeakyReLU as max(h, 0.2h),
//     writes hv to an f32 scratch and, per (sample in the tile, column), the
//     tile's mean and centred M2 from the accumulator fragments: a
//     fixed-order warp shuffle over the 8 lanes that share a column, then a
//     fixed-order sum over warps in shared memory (the warps that hold none
//     of a sample's rows add exact zeros, so a sample's sum does not depend
//     on its slot in a tile of several).  Partials go to an
//     (N, tiles, Cout) buffer instead of atomics, so every run gives the
//     same bits.
//   * Pass 2a (finalize_moments, common.cuh): Chan's merge of the partials
//     into per-(sample, channel) scale and shift.  This deviates from the
//     TPU kernel's one-pass var = E[h^2] - mean^2: at 262,144 pixels per
//     sample the cancellation would cost digits.
//   * Pass 2b (affine_apply): out = scale * hv + shift, 16-byte loads, one
//     block row per sample with (sample, channel) carried by the loop.
//     The statistics span all H*W of a sample, so the normalize pass cannot
//     join pass 1 without a grid-wide barrier.
//
// The f32 route keeps the CUDA-core main loop (conv3x3_f32): f32 is the
// parity mode that chip_smoke.py and the card tests hold at 1e-4 with TF32
// off, and TF32 tensor cores would break that tolerance.
//
// Training: the TPU kernel's emit_hv variant (_call_kernel with
// emit_hv=True, reached from the custom_vjp's _styleconv_fwd) also writes hv
// as the backward's residual, in x's dtype.  Here hv is pass 1's f32
// scratch, handed to the caller as it is (more exact than a bf16 copy, and
// no extra write), and pass 2a also writes the per-(sample, channel) mean
// and inv = rsqrt(var + eps) when mean_out is not null, so the backward
// (K3, styleconv_bwd.cu) need not recompute them.  Inference passes null.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace byogan {
namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32 route: CUDA-core implicit GEMM over runs of BM pixels of one sample.

constexpr int kF32Threads = 256;
constexpr int kF32BK = 16;  // input channels per shared-memory slice
constexpr int TM = 4, TN = 4;

template <int BM, int BN>
__global__ void __launch_bounds__(kF32Threads)
    conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ noise,
                const float* __restrict__ noise_w, float* __restrict__ hv,
                float* __restrict__ part_mean, float* __restrict__ part_m2,
                int H, int W, int Cin, int Cout, int tiles) {
  constexpr int BK = kF32BK;
  constexpr int NTX = BN / TN;  // threads along output channels
  constexpr int NTY = BM / TM;  // threads along pixels
  static_assert(NTX * NTY == kF32Threads, "one 4x4 micro-tile per thread");
  constexpr int A_ROWS = kF32Threads / BK;  // pixel rows loaded per pass
  constexpr int A_ITERS = BM / A_ROWS;
  constexpr int B_ITERS = BK * BN / kF32Threads;
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
  const float* xs = x + (long long)s * HW * Cin;

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
    const float* wt = w + (long long)tap * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + ak;
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int yy = ay[i] + dy, xx = ax[i] + dx;
        float v = 0.f;
        if (ci < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = xs[((long long)yy * W + xx) * Cin + ci];
        As[ak][tid / BK + i * A_ROWS] = v;
      }
#pragma unroll
      for (int i = 0; i < B_ITERS; ++i) {
        const int e = tid + i * kF32Threads;
        const int bk = e / BN, bn = e % BN;
        const int cj = c0 + bk, co = n0 + bn;
        Bs[bk][bn] = (cj < Cin && co < Cout) ? wt[(long long)cj * Cout + co] : 0.f;
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
      const float nz = noise[pix];
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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores.

constexpr int kBK = 16;        // input channels per slice (plan_tiles)
constexpr int kStages = 3;     // depth of the cp.async ring
constexpr int kMaxHalo = 336;  // halo pixels a tile may stage (plan_tiles)
constexpr int kMaxSpt = 8;     // whole samples a tile may hold (plan_tiles)

// Bytes of one pipeline stage: the halo patch, then the 9 x BK x BN weight
// slice, each row padded by 8 bf16 (16 bytes) against bank conflicts.
__host__ __device__ constexpr int stage_bytes(int halo_px, int bk, int bn) {
  return halo_px * (bk + 8) * 2 + 9 * bk * (bn + 8) * 2;
}

// Bytes of the epilogue's reduction scratch, which reuses the pipeline's.
__host__ __device__ constexpr int epilogue_bytes(int spt, int warps_m, int bn) {
  return (spt * warps_m * bn + spt * bn) * 4;
}

// The tile's pixels: `spt` whole samples (spt > 1: th, tw = H, W and one
// tile per sample group), or one th x tw rectangle of one sample, the
// rectangles numbered row by row, tiles_x to a row.
struct TilePlan {
  int th, tw, spt, tiles_x, tiles_y;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing.
// The input goes around L1 (.cg); the weight, which every block of a call
// reads, is kept in L1 (.ca), so the blocks on one SM share it instead of
// all asking the few L2 slices that hold it.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_l1(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); each thread holds c at rows g, g+8
// and columns 2t, 2t+1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    conv3x3_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ noise,
                const float* __restrict__ noise_w, float* __restrict__ hv,
                float* __restrict__ part_mean, float* __restrict__ part_m2,
                int N, int H, int W, int Cin, int Cout, TilePlan tp) {
  constexpr int NT = WARPS_M * WARPS_N * 32, BK = kBK;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile of m16 x n16 blocks");
  constexpr int KCH = BK / 8;  // 16-byte chunks per halo pixel
  constexpr int HROW = BK + 8, WROW = BN + 8;  // padded row pitch, bf16
  constexpr int HCH = (kMaxHalo * KCH + NT - 1) / NT;
  constexpr int WCH = 9 * BK * (BN / 8);  // 16-byte weight chunks per stage
  static_assert(NT % KCH == 0, "a thread copies one channel chunk");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int n0 = blockIdx.y * BN;
  const int tw2 = tp.tw + 2, hp = (tp.th + 2) * tw2;  // halo pitch, pixels
  const int halo_px = tp.spt * hp;
  const int sbytes = stage_bytes(halo_px, BK, BN);
  const int hw_t = tp.th * tp.tw;  // pixels of one sample in the tile

  // Where the tile lies: first sample, rectangle origin, tile index.
  int s0, y0 = 0, x0 = 0, t_in = 0;
  if (tp.spt > 1) {
    s0 = blockIdx.x * tp.spt;
  } else {
    const int tps = tp.tiles_x * tp.tiles_y;
    s0 = blockIdx.x / tps;
    t_in = blockIdx.x - s0 * tps;
    y0 = (t_in / tp.tiles_x) * tp.th;
    x0 = (t_in % tp.tiles_x) * tp.tw;
  }

  // The halo chunks this thread copies: the global pixel index of each
  // (-1 outside the image: zero-filled; -2 past the halo: none).
  const int q = tid % KCH;
  int hpix[HCH];
#pragma unroll
  for (int k = 0; k < HCH; ++k) {
    const int p = (tid + k * NT) / KCH;
    hpix[k] = -2;
    if (p < halo_px) {
      const int j = p / hp, r = p - j * hp;
      const int yy = y0 - 1 + r / tw2, xx = x0 - 1 + r % tw2, s = s0 + j;
      const bool in = s < N && yy >= 0 && yy < H && xx >= 0 && xx < W;
      hpix[k] = in ? (s * H + yy) * W + xx : -1;
    }
  }
  // 16-byte copies need 16-byte aligned rows: channel counts that are
  // multiples of 8 and base pointers on 16 bytes (a view may start anywhere).
  const bool vec_x = (Cin & 7) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = (Cout & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  auto load_stage = [&](int stage, int c0) {
    unsigned char* base = smem + stage * sbytes;
    bf16* halo = reinterpret_cast<bf16*>(base);
    bf16* wts = reinterpret_cast<bf16*>(base + halo_px * HROW * 2);
    const int c = c0 + q * 8;
#pragma unroll
    for (int k = 0; k < HCH; ++k) {
      if (hpix[k] == -2) continue;
      bf16* dst = halo + ((tid + k * NT) / KCH) * HROW + q * 8;
      const bf16* src = x + (long long)max(hpix[k], 0) * Cin + c;
      if (vec_x) {
        cp_async16(smem_u32(dst), hpix[k] >= 0 && c < Cin ? src : x,
                   hpix[k] >= 0 && c < Cin);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = hpix[k] >= 0 && c + e < Cin ? src[e] : __float2bfloat16(0.f);
      }
    }
    for (int i = tid; i < WCH; i += NT) {
      const int col = (i % (BN / 8)) * 8, k = (i / (BN / 8)) % BK,
                tap = i / (BN / 8 * BK);
      bf16* dst = wts + (tap * BK + k) * WROW + col;
      const int ci = c0 + k, co = n0 + col;
      const bf16* src = w + ((long long)tap * Cin + ci) * Cout + co;
      if (vec_w) {
        const bool ok = ci < Cin && co < Cout;
        cp_async16_l1(smem_u32(dst), ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ci < Cin && co + e < Cout ? src[e] : __float2bfloat16(0.f);
      }
    }
  };

  // ldmatrix row addresses: lane l gives row l % 16 of each m16 block (its
  // halo pixel at tap (0, 0)) at channel offset 8 * (l / 16); rows past the
  // tile's samples read halo pixel 0 and are masked in the epilogue.
  int a_base[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = warp_m * WM + mi * 16 + (lane & 15);
    const int j = m / hw_t, l = m - j * hw_t;
    a_base[mi] = j < tp.spt ? j * hp + (l / tp.tw) * tw2 + l % tp.tw : 0;
  }
  const int a_koff = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // Slice kt goes to ring buffer kt % kStages; where Cin has fewer than
  // kStages slices, only that many buffers exist (plan_tiles).
  const int KT = (Cin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt has landed; slice kt-1's buffer is free
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * BK);
    cp_async_commit();

    const uint32_t halo_u = smem_u32(smem + (kt % kStages) * sbytes);
    const uint32_t w_u = halo_u + halo_px * HROW * 2;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * tw2 + tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi], halo_u + ((a_base[mi] + shift) * HROW + kk * 16 + a_koff) * 2);
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, w_u + ((tap * BK + kk * 16 + b_k) * WROW + warp_n * WN +
                                  np * 16 + b_n) * 2);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory is free for the epilogue

  // Epilogue.  Thread rows: m = warp_m*WM + mi*16 + g + 8h; columns
  // n0 + warp_n*WN + ni*8 + 2t + e, accumulator element 2h + e.
  const int g = lane >> 2, t4 = lane & 3;
  int rj[MI][2];       // sample of the row within the tile, -1 if no pixel
  long long rpix[MI][2];
  float nz[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp_m * WM + mi * 16 + g + 8 * h;
      const int j = m / hw_t, l = m - j * hw_t;
      const int yy = y0 + l / tp.tw, xx = x0 + l % tp.tw, s = s0 + j;
      const bool ok = j < tp.spt && s < N && yy < H && xx < W;
      rj[mi][h] = ok ? j : -1;
      rpix[mi][h] = ok ? ((long long)s * H + yy) * W + xx : 0;
      nz[mi][h] = ok ? __bfloat162float(noise[rpix[mi][h]]) : 0.f;
    }
  const bool pair_store = (Cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = n0 + warp_n * WN + ni * 8 + 2 * t4;
    float bv[2], nwv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bv[e] = col + e < Cout ? bias[col + e] : 0.f;
      nwv[e] = col + e < Cout ? noise_w[col + e] : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[mi][ni][2 * h + e] + bv[e] + nwv[e] * nz[mi][h];
          v[e] = fmaxf(v[e], 0.2f * v[e]);
          acc[mi][ni][2 * h + e] = v[e];
        }
        if (rj[mi][h] < 0) continue;
        float* dst = hv + rpix[mi][h] * Cout + col;
        if (pair_store && col + 1 < Cout) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < Cout) dst[e] = v[e];
        }
      }
  }

  // Per (sample in the tile, column): the tile's mean, then its centred M2.
  float* red = reinterpret_cast<float*>(smem);  // [spt][WARPS_M][BN]
  float* mu = red + tp.spt * WARPS_M * BN;      // [spt][BN]
  const int cnt_rect = min(tp.th, H - y0) * min(tp.tw, W - x0);
  auto count = [&](int j) { return tp.spt > 1 ? (s0 + j < N ? hw_t : 0) : cnt_rect; };
  auto column_sums = [&](bool centred) {
    for (int j = 0; j < tp.spt; ++j) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = warp_n * WN + ni * 8 + 2 * t4 + e;
          const float m = centred ? mu[j * BN + c] : 0.f;
          float sum = 0.f;
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float d = acc[mi][ni][2 * h + e] - m;
              if (rj[mi][h] == j) sum += centred ? d * d : d;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          if (g == 0) red[(j * WARPS_M + warp_m) * BN + c] = sum;
        }
    }
    __syncthreads();
  };

  column_sums(false);
  for (int i = tid; i < tp.spt * BN; i += NT) {
    const int j = i / BN, c = i - j * BN;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS_M; ++r) sum += red[(j * WARPS_M + r) * BN + c];
    const int cnt = count(j);
    mu[i] = cnt > 0 ? sum / (float)cnt : 0.f;
  }
  __syncthreads();
  column_sums(true);
  const int tiles = tp.spt > 1 ? 1 : tp.tiles_x * tp.tiles_y;
  for (int i = tid; i < tp.spt * BN; i += NT) {
    const int j = i / BN, c = i - j * BN;
    if (count(j) == 0 || n0 + c >= Cout) continue;
    float m2 = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS_M; ++r) m2 += red[(j * WARPS_M + r) * BN + c];
    const long long idx = ((long long)(s0 + j) * tiles + t_in) * Cout + n0 + c;
    part_mean[idx] = mu[i];
    part_m2[idx] = m2;
  }
}

// ---------------------------------------------------------------------------
// Pass 2b: out[s, p, c] = scale[s, c] * hv[s, p, c] + shift[s, c], in T.
// Block row blockIdx.y is sample s; VEC consecutive channels per thread
// (VEC = 4 needs C % 4 == 0); the channel index is carried by the loop:
// each step advances it by dc = stride % C.

__device__ __forceinline__ void store_vec(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(bf16* dst, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <typename T, int VEC>
__global__ void affine_apply(const float* __restrict__ hv,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift, T* __restrict__ out,
                             int hwc, int C, int dc) {
  extern __shared__ float ss[];  // scale[C], shift[C] of this sample
  const int s = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    ss[c] = scale[s * C + c];
    ss[C + c] = shift[s * C + c];
  }
  __syncthreads();
  const long long base = (long long)s * hwc;
  const int stride = gridDim.x * blockDim.x * VEC;
  int i = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  int c = i % C;
  for (; i < hwc; i += stride) {
    if (VEC == 4) {
      const float4 h = *reinterpret_cast<const float4*>(hv + base + i);
      const float v[4] = {fmaf(ss[c], h.x, ss[C + c]), fmaf(ss[c + 1], h.y, ss[C + c + 1]),
                          fmaf(ss[c + 2], h.z, ss[C + c + 2]), fmaf(ss[c + 3], h.w, ss[C + c + 3])};
      store_vec(out + base + i, v);
    } else {
      out[base + i] = from_f<T>(fmaf(ss[c], hv[base + i], ss[C + c]));
    }
    c += dc;
    if (c >= C) c -= C;
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Args {
  const void *x, *w;
  const float *bias, *nw;
  const void* noise;
  float *hv, *pm, *pm2;
  int n, h, wd, cin, cout;
};

template <int BM, int BN>
int launch_f32(const Args& a, int tiles, cudaStream_t stream) {
  const dim3 grid(tiles, (a.cout + BN - 1) / BN, a.n);
  conv3x3_f32<BM, BN><<<grid, kF32Threads, 0, stream>>>(
      (const float*)a.x, (const float*)a.w, a.bias, (const float*)a.noise, a.nw,
      a.hv, a.pm, a.pm2, a.h, a.wd, a.cin, a.cout, tiles);
  return 0;
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch_mma(const Args& a, TilePlan tp, int m_tiles, int stages, int smem,
               cudaStream_t stream) {
  const int halo_px = tp.spt * (tp.th + 2) * (tp.tw + 2);
  if (stages != std::min(kStages, (a.cin + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;
  const int need = std::max(stages * stage_bytes(halo_px, kBK, BN),
                            epilogue_bytes(tp.spt, WARPS_M, BN));
  if (tp.th * tp.tw * tp.spt > BM || halo_px > kMaxHalo || tp.spt > kMaxSpt ||
      smem < need)
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_mma<BM, BN, WARPS_M, WARPS_N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(m_tiles, (a.cout + BN - 1) / BN);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
      (const bf16*)a.x, (const bf16*)a.w, a.bias, (const bf16*)a.noise, a.nw,
      a.hv, a.pm, a.pm2, a.n, a.h, a.wd, a.cin, a.cout, tp);
  return 0;
}

// The bf16 tile configurations plan_tiles may choose: (BM, BN) -> warps
// along M and N.
int launch_bf16(const Args& a, int bm, int bn, TilePlan tp, int m_tiles,
                int stages, int smem, cudaStream_t st) {
#define BYOGAN_TILE(BM, BN, WM, WN) \
  if (bm == BM && bn == BN)         \
    return launch_mma<BM, BN, WM, WN>(a, tp, m_tiles, stages, smem, st);
  BYOGAN_TILE(256, 64, 4, 2)
  BYOGAN_TILE(128, 64, 4, 2)
  BYOGAN_TILE(64, 64, 2, 2)
  BYOGAN_TILE(32, 64, 2, 2)
  BYOGAN_TILE(16, 64, 1, 4)
  BYOGAN_TILE(256, 32, 8, 1)
  BYOGAN_TILE(128, 32, 4, 1)
  BYOGAN_TILE(256, 16, 4, 1)
  BYOGAN_TILE(128, 16, 4, 1)
#undef BYOGAN_TILE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int finish(const Args& a, const void* gamma, const void* beta, void* out,
           float* scale_shift, float* mean_out, float* inv_out, int tiles,
           TileGrid grid, float eps, cudaStream_t stream) {
  const int n = a.n, cout = a.cout, hw = a.h * a.wd;
  float* scale = scale_shift;
  float* shift = scale_shift + (long long)n * cout;
  finalize_moments<T><<<dim3(cout, n), finalize_threads(tiles), 0, stream>>>(
      a.pm, a.pm2, (const T*)gamma, (const T*)beta, scale, shift, mean_out,
      inv_out, tiles, grid, cout, eps);
  const int hwc = hw * cout, vec = cout % 4 == 0 ? 4 : 1;
  const int want = (hwc / vec + 255) / 256;
  const int per_sample = std::max(1, std::min(want, (132 * 8 + n - 1) / n));
  const int dc = (int)((long long)per_sample * 256 * vec % cout);
  const dim3 g(per_sample, n);
  const size_t sm = 2 * cout * sizeof(float);
  if (vec == 4)
    affine_apply<T, 4><<<g, 256, sm, stream>>>(a.hv, scale, shift, (T*)out, hwc, cout, dc);
  else
    affine_apply<T, 1><<<g, 256, sm, stream>>>(a.hv, scale, shift, (T*)out, hwc, cout, dc);
  return 0;
}

}  // namespace
}  // namespace byogan

// Tile plan (ops/styleconv.py::plan_tiles): bm pixels x bn output channels
// per block, in slices of kBK input channels; th x tw the rectangle of one
// sample, or spt > 1 whole samples; stages and smem the pipeline's depth and
// dynamic shared-memory bytes (0 on the f32 route, whose tiles are runs of
// bm pixels with bn = 4096 / bm).
extern "C" int styleconv_forward(const void* x, const void* w, const void* bias,
                                 const void* noise, const void* noise_w,
                                 const void* gamma, const void* beta, void* out,
                                 void* hv, void* part_mean, void* part_m2,
                                 void* scale_shift, void* mean_out,
                                 void* inv_out, int n, int h, int w_, int cin,
                                 int cout, int bm, int bn, int th, int tw,
                                 int spt, int stages, int smem,
                                 float eps, int dtype, void* stream) {
  using namespace byogan;
  auto st = (cudaStream_t)stream;
  auto f = [](void* p) { return (float*)p; };
  const Args a{x, w, (const float*)bias, (const float*)noise_w, noise,
               f(hv), f(part_mean), f(part_m2), n, h, w_, cin, cout};
  int code = 0;
  if (dtype == kFloat32) {
    const int hw = h * w_, tiles = (hw + bm - 1) / bm;
    if (bm == 64 && bn == 64) code = launch_f32<64, 64>(a, tiles, st);
    else if (bm == 128 && bn == 32) code = launch_f32<128, 32>(a, tiles, st);
    else if (bm == 256 && bn == 16) code = launch_f32<256, 16>(a, tiles, st);
    else return (int)cudaErrorInvalidValue;
    if (code) return code;
    code = finish<float>(a, gamma, beta, out, f(scale_shift), f(mean_out),
                         f(inv_out), tiles, TileGrid{1, hw, 1, bm, tiles}, eps, st);
  } else if (dtype == kBFloat16) {
    const bool packed = spt > 1;
    const TilePlan tp{th, tw, spt, packed ? 1 : (w_ + tw - 1) / tw,
                      packed ? 1 : (h + th - 1) / th};
    const int tiles = tp.tiles_x * tp.tiles_y;
    const int m_tiles = packed ? (n + spt - 1) / spt : n * tiles;
    code = launch_bf16(a, bm, bn, tp, m_tiles, stages, smem, st);
    if (code) return code;
    code = finish<__nv_bfloat16>(a, gamma, beta, out, f(scale_shift),
                                 f(mean_out), f(inv_out), tiles,
                                 TileGrid{h, w_, th, tw, tp.tiles_x}, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (code) return code;
  return (int)cudaGetLastError();
}
