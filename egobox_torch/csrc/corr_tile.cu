// K1: correlation (Gram) tile kernel for the L1-family GP kernels.
//
// Replaces egobox_tpu/ops/pallas_corr.py: corr_cross_pallas -> _tile_kernel
// (pallas_call at :73). Computes
//     r[i, j] = exp( sum_f term(|x1[i, f] - x2[j, f]| * thw[f]) )
// for absolute_exponential, matern32 and matern52 (squared_exponential as a
// fallback), float32 in and out, identity KPLS weights.
//
// What bounds it on the H100: the transcendental work. Every output costs d
// log1pf calls (Matern) plus one expf, about 20-40 FP32 instructions each,
// against 4 bytes written; at n=10000, d=10 that is 1e9 log1pf for 400 MB
// of output, so the kernel sits on the FP32 pipes, not on HBM.
//
// Design: one CTA of 256 threads per 64x64 output tile, each thread owning a
// 4x4 sub-block strided by 16 (neighbouring threads write neighbouring
// columns). The CTA stages its 64 x1 rows and 64 x2 rows in shared memory in
// chunks of 32 features, so any d works, with theta beside them; log r is
// accumulated in registers and expf is applied once per output. Ragged edges
// are masked in the kernel: no padded copies of the inputs or the output.
// log1pf/expf are the accurate library functions (the parity target against
// the plain version is 2e-6 absolute); the build uses no --use_fast_math.
// CUDA C++ was chosen over Triton so that both kernels of the port share one
// nvcc build and one ctypes binding.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kThreads = 16;  // threads per tile edge (4x4 outputs each)
constexpr int kChunk = 32;    // features staged per pass

enum Kind { kSqexp = 0, kAbsexp = 1, kMatern32 = 2, kMatern52 = 3 };

template <int KIND>
__device__ __forceinline__ float log_term(float u) {
  if (KIND == kAbsexp) return -u;
  if (KIND == kMatern32) {
    const float v = 1.7320508075688772f * u;
    return log1pf(v) - v;
  }
  if (KIND == kMatern52) {
    const float v = 2.23606797749979f * u;
    return log1pf(v + (5.0f / 3.0f) * u * u) - v;
  }
  return -0.5f * u * u;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads * kThreads)
corr_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ thw, float* __restrict__ out,
                 int n1, int n2, int d) {
  __shared__ float s1[kTile][kChunk + 1];  // +1: no bank conflicts on rows
  __shared__ float s2[kTile][kChunk + 1];
  __shared__ float sth[kChunk];

  const int tid = threadIdx.x;
  const int tx = tid % kThreads;
  const int ty = tid / kThreads;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int f0 = 0; f0 < d; f0 += kChunk) {
    const int fc = min(kChunk, d - f0);
    for (int idx = tid; idx < kTile * kChunk; idx += kThreads * kThreads) {
      const int r = idx / kChunk;
      const int f = idx % kChunk;
      float a = 0.0f, b = 0.0f;
      if (f < fc) {
        if (row0 + r < n1) a = x1[(size_t)(row0 + r) * d + f0 + f];
        if (col0 + r < n2) b = x2[(size_t)(col0 + r) * d + f0 + f];
      }
      s1[r][f] = a;
      s2[r][f] = b;
    }
    if (tid < kChunk) sth[tid] = tid < fc ? thw[f0 + tid] : 0.0f;
    __syncthreads();

    for (int f = 0; f < fc; ++f) {
      const float t = sth[f];
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s1[ty + kThreads * i][f];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s2[tx + kThreads * j][f];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += log_term<KIND>(fabsf(a[i] - b[j]) * t);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + kThreads * i;
    if (r >= n1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + kThreads * j;
      if (c < n2) out[(size_t)r * n2 + c] = expf(acc[i][j]);
    }
  }
}

}  // namespace

// kind: 0 squared_exponential, 1 absolute_exponential, 2 matern32,
// 3 matern52. x1 (n1, d), x2 (n2, d), thw (d,), out (n1, n2): contiguous
// float32 on the current device. Returns the launch's cudaError_t.
extern "C" int egx_corr_tile(int kind, const float* x1, const float* x2,
                             const float* thw, float* out, int n1, int n2,
                             int d, cudaStream_t stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  const dim3 block(kThreads * kThreads);
  switch (kind) {
    case kSqexp:
      corr_tile_kernel<kSqexp><<<grid, block, 0, stream>>>(x1, x2, thw, out,
                                                           n1, n2, d);
      break;
    case kAbsexp:
      corr_tile_kernel<kAbsexp><<<grid, block, 0, stream>>>(x1, x2, thw, out,
                                                            n1, n2, d);
      break;
    case kMatern32:
      corr_tile_kernel<kMatern32><<<grid, block, 0, stream>>>(
          x1, x2, thw, out, n1, n2, d);
      break;
    case kMatern52:
      corr_tile_kernel<kMatern52><<<grid, block, 0, stream>>>(
          x1, x2, thw, out, n1, n2, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
