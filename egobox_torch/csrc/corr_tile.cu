// K1: correlation (Gram) tile kernel for the L1-family GP kernels.
//
// Replaces egobox_tpu/ops/pallas_corr.py: corr_cross_pallas -> _tile_kernel
// (pallas_call at :73). Computes
//     r[i, j] = exp( sum_f term(|x1[i, f] - x2[j, f]| * thw[f]) )
// for absolute_exponential, matern32 and matern52 (squared_exponential as a
// fallback), float32 in and out, identity KPLS weights; optionally also the
// per-row partial sums of r over each tile column (the Gershgorin row sums
// of the likelihood's R without a second pass over it).
//
// What bounds it on the H100: FP32 instruction issue, then the stores. An
// output costs d terms against 4 bytes written, and at n=10000, d=10 the
// 1e9 terms must each stay at a handful of instructions for the 400 MB of
// stores to show at all. So:
//
// - Product form. The Pallas kernel sums log1p(v + 5/3 u^2) - v per term;
//   here a Matern term multiplies its polynomial into a running product
//   and adds v to a running sum (6 instructions for Matern 5/2, 4 for
//   Matern 3/2, no transcendental), and every 8 features the product is
//   folded: p <- p * exp(-sum v), sum <- 0 (one ex2.approx and four more
//   instructions per 8 terms). After a fold p is the partial correlation,
//   at most 1. Eight factors overflow float32 only if one of them has
//   v > 400, where exp(-sum v) is long 0: the fold turns an infinite
//   product into an exact 0, never into inf * 0. absexp and sqexp only
//   sum, with one exp at the end. Results below FLT_MIN are stored as 0,
//   so r is 0 wherever the log-space formula underflows.
// - One CTA of 128 threads per 64x64 output tile, each thread 8 rows x 4
//   neighbouring columns (32 products + 32 sums in registers). Operands are
//   staged feature-major in shared memory in chunks of 32 features (any d
//   works), with the scaled theta beside them, and read as 16-byte vectors:
//   3 loads per 32 terms. Rows are stored as 16-byte vectors, 16
//   neighbouring threads on 256 neighbouring bytes. Small tiles keep the
//   2000^2 Gram in whole waves (4 CTAs per SM: 528 slots, its 528 tiles).
// - Symmetric Grams (x1 and x2 the same tensor) launch only the tiles on
//   and below the diagonal; an off-diagonal CTA also stores the transpose
//   of its tile, turned in shared memory so that both stores are coalesced
//   (measured: 0.233 ms against 0.256 ms with the transpose stored straight
//   from the registers, 10000^2 Matern 5/2, d=10, H100). Diagonal tiles
//   are symmetric bit for bit because |a - b| and the feature order are
//   the same on both sides, so the whole Gram is.
// - Row sums are reduced in a fixed order (registers, half-warp shuffles,
//   then one partial per row and tile column in a scratch matrix that the
//   wrapper sums): no float atomics, the same bits on every run. The
//   mirrored tile adds its column sums to the other rows' partials.
//
// Not used, on purpose: tensor cores (an L1-family Gram has no matrix
// product), TMA (a tile's inputs are 2 x 64 x d floats and its output is
// only written), and a 16-bit output (R feeds a float32 Cholesky).
// Ragged edges are masked in the kernel: no padded copies. The build uses
// no --use_fast_math. CUDA C++ rather than Triton so that both kernels of
// the port share one nvcc build and one ctypes binding.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kTile = 64;    // output tile edge
constexpr int kTx = 16;      // threads along the columns (4 columns each)
constexpr int kTy = 8;       // threads along the rows (8 rows each)
constexpr int kThreads = kTx * kTy;
constexpr int kRows = 8;     // outputs per thread, rows
constexpr int kCols = 4;     // outputs per thread, columns (one float4)
constexpr int kChunk = 32;   // features staged per pass
constexpr int kGroup = 8;    // Matern terms between two folds

enum Kind { kSqexp = 0, kAbsexp = 1, kMatern32 = 2, kMatern52 = 3 };

// One term: p is the running product (Matern), q the running sum.
template <int KIND>
__device__ __forceinline__ void term(float a, float b, float s, float& p,
                                     float& q) {
  const float dx = a - b;
  if (KIND == kSqexp) {
    const float u = dx * s;
    q = fmaf(u, u, q);
  } else if (KIND == kAbsexp) {
    q = fmaf(fabsf(dx), s, q);
  } else {
    const float v = fabsf(dx) * s;  // s holds sqrt(3) or sqrt(5) times theta
    q += v;
    if (KIND == kMatern32) {
      p = fmaf(p, v, p);  // p (1 + v)
    } else {
      const float u = v * fmaf(v, 1.0f / 3.0f, 1.0f);
      p = fmaf(p, u, p);  // p (1 + v + v^2 / 3)
    }
  }
}

// Fold a Matern group: p <- p exp(-q), q <- 0. The product of a group can
// only overflow when one of its terms has v > 400, and exp(-q) is 0 from
// q = 104 on: an infinite product folds to an exact 0, never to inf * 0.
__device__ __forceinline__ void fold(float& p, float& q) {
  float e;
  asm("ex2.approx.f32 %0, %1;" : "=f"(e) : "f"(q * -1.4426950408889634f));
  const float t = p * e;
  p = p == INFINITY ? 0.0f : t;  // a NaN stays a NaN
  q = 0.0f;
}

template <int KIND, bool SYM>
__global__ void __launch_bounds__(kThreads, 4)
corr_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ thw, float* __restrict__ out,
                 float* __restrict__ sums, int n1, int n2, int d, int nt2) {
  __shared__ __align__(16) float s1[kChunk][kTile];  // feature-major
  __shared__ __align__(16) float s2[kChunk][kTile];
  __shared__ float ssc[kChunk];
  __shared__ float scol[SYM ? kTy : 1][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  int bi, bj;
  if (SYM) {
    // blockIdx.x counts the tiles on and below the diagonal, row by row
    const int k = blockIdx.x;
    bi = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
    while (bi * (bi + 1) / 2 > k) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= k) ++bi;
    bj = k - bi * (bi + 1) / 2;
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const int row0 = bi * kTile;
  const int col0 = bj * kTile;

  float p[kRows][kCols], q[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      p[i][j] = 1.0f;
      q[i][j] = 0.0f;
    }

  const float scale = KIND == kMatern32   ? 1.7320508075688772f
                      : KIND == kMatern52 ? 2.23606797749979f
                                          : 1.0f;
  for (int f0 = 0; f0 < d; f0 += kChunk) {
    const int fc = min(kChunk, d - f0);
    for (int idx = tid; idx < kTile * fc; idx += kThreads) {
      const int r = idx / fc;
      const int f = idx - r * fc;
      s1[f][r] = row0 + r < n1 ? x1[(size_t)(row0 + r) * d + f0 + f] : 0.0f;
      s2[f][r] = col0 + r < n2 ? x2[(size_t)(col0 + r) * d + f0 + f] : 0.0f;
    }
    if (tid < fc) ssc[tid] = scale * thw[f0 + tid];
    __syncthreads();

    for (int g = 0; g < fc; g += kGroup) {
#pragma unroll
      for (int ff = 0; ff < kGroup; ++ff) {
        const int f = g + ff;
        if (f < fc) {
          const float s = ssc[f];
          const float4 a0 =
              *reinterpret_cast<const float4*>(&s1[f][ty * kRows]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&s1[f][ty * kRows + 4]);
          const float4 b4 =
              *reinterpret_cast<const float4*>(&s2[f][tx * kCols]);
          const float a[kRows] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
          const float b[kCols] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              term<KIND>(a[i], b[j], s, p[i][j], q[i][j]);
        }
      }
      if (KIND == kMatern32 || KIND == kMatern52) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) fold(p[i][j], q[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float r = p[i][j];
      if (KIND == kAbsexp) r = expf(-q[i][j]);
      if (KIND == kSqexp) r = expf(-0.5f * q[i][j]);
      p[i][j] = r < FLT_MIN ? 0.0f : r;  // NaN stays NaN
    }

  const int rbase = row0 + ty * kRows;  // this thread's first row
  const int cbase = col0 + tx * kCols;  // this thread's first column
  const bool vec = (n2 & 3) == 0;       // rows of out start on 16 bytes
  const bool mirror = SYM && bi != bj;

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rbase + i;
    if (r >= n1) continue;
    float* dst = out + (size_t)r * n2 + cbase;
    if (vec) {
      if (cbase < n2)
        *reinterpret_cast<float4*>(dst) =
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (cbase + j < n2) dst[j] = p[i][j];
    }
  }
  if (mirror) {
    // the transpose of the tile is the tile (bj, bi) of out (n1 == n2)
    if (vec) {
      // through shared memory, so that its rows too leave as 256
      // neighbouring bytes from 16 neighbouring threads
      __shared__ __align__(16) float st[kTile][kTile + 4];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        *reinterpret_cast<float4*>(&st[tx * kCols + j][ty * kRows]) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
        *reinterpret_cast<float4*>(&st[tx * kCols + j][ty * kRows + 4]) =
            make_float4(p[4][j], p[5][j], p[6][j], p[7][j]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int row = ty * kRows + k;
        const int c = col0 + row;
        const int cc = row0 + tx * kCols;
        if (c < n2 && cc < n1)
          *reinterpret_cast<float4*>(out + (size_t)c * n2 + cc) =
              *reinterpret_cast<const float4*>(&st[row][tx * kCols]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cbase + j;
        if (c >= n2) continue;
        float* dst = out + (size_t)c * n2 + rbase;
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (rbase + i < n1) dst[i] = p[i][j];
      }
    }
  }

  if (sums != nullptr) {
    // r >= 0, so the sum of |r| is the sum of r; edges count as 0
    float cs[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool row_ok = rbase + i < n1;
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float v = (row_ok && cbase + j < n2) ? p[i][j] : 0.0f;
        t += v;
        cs[j] += v;
      }
      // over the 16 threads of this row: one half-warp
#pragma unroll
      for (int m = 1; m < kTx; m <<= 1)
        t += __shfl_xor_sync(0xffffffffu, t, m);
      if (tx == 0 && row_ok) sums[(size_t)(rbase + i) * nt2 + bj] = t;
    }
    if (mirror) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) scol[ty][tx * kCols + j] = cs[j];
      __syncthreads();
      if (tid < kTile && col0 + tid < n2) {
        float t = 0.0f;
#pragma unroll
        for (int y = 0; y < kTy; ++y) t += scol[y][tid];
        sums[(size_t)(col0 + tid) * nt2 + bi] = t;
      }
    }
  }
}

template <int KIND>
void launch(const float* x1, const float* x2, const float* thw, float* out,
            float* sums, int n1, int n2, int d, int symmetric,
            cudaStream_t stream) {
  const int nt1 = (n1 + kTile - 1) / kTile;
  const int nt2 = (n2 + kTile - 1) / kTile;
  if (symmetric) {
    corr_tile_kernel<KIND, true><<<nt1 * (nt1 + 1) / 2, kThreads, 0, stream>>>(
        x1, x2, thw, out, sums, n1, n2, d, nt2);
  } else {
    corr_tile_kernel<KIND, false><<<dim3(nt2, nt1), kThreads, 0, stream>>>(
        x1, x2, thw, out, sums, n1, n2, d, nt2);
  }
}

}  // namespace

// kind: 0 squared_exponential, 1 absolute_exponential, 2 matern32,
// 3 matern52. x1 (n1, d), x2 (n2, d), thw (d,), out (n1, n2): contiguous
// float32 on the current device. sums: null, or (n1, ceil(n2 / 64)) float32
// that receives, per row, the sum of r over each tile of 64 columns.
// symmetric != 0 asserts that x1 and x2 are the same matrix (n1 == n2): only
// the lower tiles are computed and each is stored with its transpose.
// Returns the launch's cudaError_t.
extern "C" int egx_corr_tile(int kind, const float* x1, const float* x2,
                             const float* thw, float* out, float* sums,
                             int n1, int n2, int d, int symmetric,
                             cudaStream_t stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  if (symmetric && n1 != n2) return (int)cudaErrorInvalidValue;
  if ((n1 + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case kSqexp:
      launch<kSqexp>(x1, x2, thw, out, sums, n1, n2, d, symmetric, stream);
      break;
    case kAbsexp:
      launch<kAbsexp>(x1, x2, thw, out, sums, n1, n2, d, symmetric, stream);
      break;
    case kMatern32:
      launch<kMatern32>(x1, x2, thw, out, sums, n1, n2, d, symmetric, stream);
      break;
    case kMatern52:
      launch<kMatern52>(x1, x2, thw, out, sums, n1, n2, d, symmetric, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
