// K2: Cholesky panel factorization for the left-looking blocked Cholesky.
//
// Replaces egobox_tpu/ops/pallas_chol.py: factor_panel ->
// _factor_panel_kernel (pallas_call at :147). For one block column
// a (m, b) = [A00; B], already updated by the left-looking GEMM, it writes
//     out[0:b]  = L00          with A00 = L00 L00^T (upper part zero)
//     out[b:m]  = B L00^-T
// The blocked loop (egobox_torch/ops/chol_kernel.py: panel_cholesky) keeps
// the trailing updates as GEMMs outside the kernel, as pallas_cholesky does.
//
// What bounds it on the H100: instruction issue on one SM. The b x b
// factorization is b sequential column steps (b^3/6 multiply-adds on the
// shrinking trailing triangle, 2.8 M at b=256) and the triangular inverse
// another b^3/6, all in one CTA, where each multiply-add costs about ten
// instructions of loads, stores and index arithmetic: 0.35 ms and 0.44 ms
// at b=256 on an H100 (700 W), against 19 us for the b steps' barriers
// alone. The panel apply, a (m-b) x b x b product (0.65 GFLOP at m=10240,
// b=256), spreads over the card. A blocked diagonal factorization, with
// its updates as register-tiled products, is the way to a faster kernel.
//
// Design:
// - Phase 1, one CTA of 1024 threads: the lower triangle of A00 is packed
//   in shared memory (b(b+1)/2 floats, 129 KB at b=256; the full 256 KB
//   block would exceed the 227 KB a CTA may use). A right-looking
//   unblocked Cholesky runs there column by column, two barriers per
//   column: scale column j into a contiguous buffer, then the rank-1
//   update of the trailing triangle, one warp per row. The TPU kernel's
//   one-hot matvecs (a Mosaic workaround for dynamic lane indexing, O(b^3)
//   per column step) are not carried over: shared memory is indexed
//   directly. L00 is written out, then inverted in place in shared
//   memory, column by column from the right (LAPACK's trti2 order):
//   X[i][j] = -X[j][j] sum_{j<k<=i} X[i][k] L[k][j], one warp per row and a
//   shuffle reduction, all rows of a column at once. L00^-1 goes to a
//   b x b scratch in global memory for phase 2. Every step reads its
//   column from the contiguous buffer: read in place, with its stride of
//   i + 1 floats, the lanes of a warp conflict on the shared-memory banks.
// - Phase 2, a grid over 64x64 output tiles of the rows below: a tiled
//   FFMA product B L00^-T (64x16 slabs of B and L00^-1 staged in shared
//   memory, 4x4 outputs per thread), as the TPU kernel applies L00^-1 with
//   its in-kernel MXU dot. m is taken at run time: no row padding.
// - A non-positive (or NaN) pivot gives NaN, never a trap, so the
//   likelihood that consumes the factor becomes -inf.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// sqrt(pivot) and 1/sqrt(pivot), NaN for a non-positive (or NaN) pivot
__device__ __forceinline__ float sqrt_pivot(float piv) {
  return piv > 0.0f ? sqrtf(piv) : __int_as_float(0x7fc00000);
}
__device__ __forceinline__ float inv_sqrt_pivot(float piv) {
  return piv > 0.0f ? 1.0f / sqrtf(piv) : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(1024)
panel_diag_kernel(const float* __restrict__ a, float* __restrict__ out,
                  float* __restrict__ linv, int b) {
  extern __shared__ float s[];  // packed lower triangle: A00, L00, L00^-1
  // the column every row reads in a step, contiguous: read from the packed
  // triangle (stride i + 1) the lanes of a warp conflict on the banks
  float* col = s + b * (b + 1) / 2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = nt / 32;

  for (int i = warp; i < b; i += nwarps)
    for (int j = lane; j <= i; j += 32) s[tri(i, j)] = a[(size_t)i * b + j];
  __syncthreads();

  for (int j = 0; j < b; ++j) {
    const float piv = s[tri(j, j)];
    const float inv = inv_sqrt_pivot(piv);
    for (int i = j + 1 + tid; i < b; i += nt) {
      const float lij = s[tri(i, j)] * inv;
      s[tri(i, j)] = lij;
      col[i] = lij;
    }
    __syncthreads();  // column j scaled; every thread has read the pivot
    if (tid == 0) s[tri(j, j)] = sqrt_pivot(piv);
    for (int i = j + 1 + warp; i < b; i += nwarps) {
      float* row = s + tri(i, 0);
      const float lij = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= lij * col[k];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < b * b; idx += nt) {
    const int i = idx / b;
    const int j = idx % b;
    out[idx] = j <= i ? s[tri(i, j)] : 0.0f;
  }

  // X = L00^-1 in place, column j from the right: X[j][j] = 1 / L[j][j],
  // X[i][j] = -X[j][j] sum_{j<k<=i} X[i][k] L[k][j] (columns > j hold X)
  for (int j = b - 1; j >= 0; --j) {
    for (int i = j + 1 + tid; i < b; i += nt) col[i] = s[tri(i, j)];
    const float xjj = 1.0f / s[tri(j, j)];
    __syncthreads();  // column j of L copied; L out has been written
    for (int i = j + 1 + warp; i < b; i += nwarps) {
      const float* row = s + tri(i, 0);
      float acc = 0.0f;
      for (int k = j + 1 + lane; k <= i; k += 32) acc += row[k] * col[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s[tri(i, j)] = -xjj * acc;
    }
    if (tid == 0) s[tri(j, j)] = xjj;
    __syncthreads();
  }

  for (int idx = tid; idx < b * b; idx += nt) {
    const int i = idx / b;
    const int c = idx % b;
    linv[idx] = c <= i ? s[tri(i, c)] : 0.0f;
  }
}

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 16;

// out[b + r][c] = sum_k a[b + r][k] * linv[c][k] for r < m - b, c < b
__global__ void __launch_bounds__(kThreads * kThreads)
panel_apply_kernel(const float* __restrict__ a, const float* __restrict__ linv,
                   float* __restrict__ out, int m, int b) {
  __shared__ float sa[kDepth][kTile + 4];  // sa[k][row]
  __shared__ float sl[kDepth][kTile + 4];  // sl[k][col] = linv[col][k]
  const int tid = threadIdx.x;
  const int tx = tid % kThreads;
  const int ty = tid / kThreads;
  const int row0 = b + blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < b; k0 += kDepth) {
    for (int idx = tid; idx < kTile * kDepth; idx += kThreads * kThreads) {
      const int r = idx / kDepth;
      const int k = idx % kDepth;
      const bool kin = k0 + k < b;
      sa[k][r] = (kin && row0 + r < m) ? a[(size_t)(row0 + r) * b + k0 + k] : 0.0f;
      sl[k][r] = (kin && col0 + r < b) ? linv[(size_t)(col0 + r) * b + k0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float av[4], lv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][ty + kThreads * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) lv[j] = sl[k][tx + kThreads * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], lv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + kThreads * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + kThreads * j;
      if (c < b) out[(size_t)r * b + c] = acc[i][j];
    }
  }
}

}  // namespace

// a, out (m, b) and linv (b, b) scratch: contiguous float32 on the current
// device, m >= b, b(b+1)/2 + b floats must fit one CTA's shared memory.
// Returns the first cudaError_t of the two launches (0 on success).
extern "C" int egx_factor_panel(const float* a, float* out, float* linv, int m,
                                int b, cudaStream_t stream) {
  const int smem = (int)(((size_t)b * (b + 1) / 2 + b) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      panel_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  panel_diag_kernel<<<1, 1024, smem, stream>>>(a, out, linv, b);
  err = cudaGetLastError();
  if (err != cudaSuccess || m == b) return (int)err;
  const dim3 grid((b + kTile - 1) / kTile, (m - b + kTile - 1) / kTile);
  panel_apply_kernel<<<grid, kThreads * kThreads, 0, stream>>>(a, linv, out, m, b);
  return (int)cudaGetLastError();
}
