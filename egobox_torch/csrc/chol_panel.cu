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
// What bounds it on the H100 (published peaks of the SXM card at its 700 W
// limit). The function is b^3/3 + (m - b) b^2 flops (0.66 GFLOP at
// m=10240, b=256: 10 us at the 67 TFLOP/s FP32 peak) on 21 MB (6 us at
// 3.35 TB/s), but two things keep any kernel far from that:
// - the b x b diagonal factorization is a chain of b dependent pivot
//   steps, so it runs in one CTA on one SM: at best b^3/3 flops at one
//   SM's 0.5 TFLOP/s, 11 us at b=256, and each pivot step adds a shuffle,
//   a reciprocal square root and a multiply-add of latency;
// - the triangular solve of the rows below is sequential along the columns
//   and parallel only across rows.
// Within those, what counts is the instructions (and shared-memory
// wavefronts) per multiply-add, and how little runs on one SM.
//
// What the design does about it:
// - panel_diag_kernel, one CTA of 512 threads (up to 128 registers each),
//   loads A00's lower triangle with cp.async (every copy in flight at
//   once) and factors it blocked in sub-panels of kNb = 32 columns,
//   right-looking, the triangle packed in shared memory (b(b+1)/2 floats,
//   129 KB at b=256, so b <= 340 fits):
//   (1) one warp factors the 32 x 32 diagonal block in registers, lane i
//       holding row i, columns exchanged by shuffles; the pivot chain is
//       one shuffle and one rsqrt per step;
//   (2) the rows below in the sub-panel are solved against it, one thread
//       per row, the row in registers and the diagonal block's columns
//       read as 16-byte broadcasts;
//   (3) the trailing triangle takes the rank-32 update as a register-tiled
//       SYRK: each thread owns 4 x 4 outputs and reads its operands from a
//       transposed copy of the sub-panel, 16 bytes per load.
//   Where the copies do not fit beside the triangle (b > 309) steps (2)
//   and (3) read the packed triangle directly. A ragged b is masked in the
//   kernel (identity rows in the diagonal warp, masked stores). No inverse
//   is formed. At b=256 the clock64 split is about 4 us load, 29 us
//   diagonal blocks, 8 us row solves, 30 us trailing updates (bound by
//   shared-memory wavefronts) and 6 us store (NVIDIA H100 80GB HBM3,
//   700 W; tools/prof_k2.py).
// - panel_apply_kernel solves X L00^T = B itself (no explicit L00^-1: half
//   the flops of multiplying by one, and no serial inverse on one SM): a
//   grid of CTAs of 32 rows each, the row tile resident in shared memory;
//   for each column block of L00 in turn, staged with cp.async, a
//   register-tiled product with the solved blocks to the left, then a
//   32-column forward substitution, one thread per row. All the
//   triangular work below the diagonal block is spread over the grid;
//   small CTAs (66 KB at b=256) let three share an SM, so one CTA's
//   substitution overlaps another's product.
// - Full FP32 throughout: the likelihood's 1e-3 relative gate against
//   float64 rules out TF32.
// - A non-positive (or NaN) pivot gives NaN, never a trap; it propagates to
//   every later column, so the likelihood that consumes the factor
//   becomes -inf.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNb = 32;            // sub-panel width: one warp
constexpr int kDiagThreads = 512;  // panel_diag_kernel's CTA
constexpr int kRows = 32;          // rows of B per panel_apply_kernel CTA
constexpr int kApplyThreads = 128;
constexpr int kLdt = 36;           // row stride of the transposed diag block

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Asynchronous 4-byte copy global -> shared: the copies of a whole tile are
// in flight at once, with no registers held (a loop of plain loads keeps a
// few in flight and waits on each).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (1) Factor the 32 x 32 diagonal block at (c0, c0) of the packed triangle
// in place; one warp, lane i holds row c0 + i. Rows past b are identity
// rows. dinv[i] receives 1 / L[c0 + i][c0 + i] for the row solves, and
// ltc (if given) the block transposed, ltc[k * kLdt + i] = L[c0+i][c0+k].
__device__ __forceinline__ void factor_diag_block(float* s, float* dinv,
                                                  float* ltc, int c0, int b,
                                                  int lane) {
  const int i = c0 + lane;
  const bool in = i < b;
  float a[kNb];
#pragma unroll
  for (int k = 0; k < kNb; ++k)
    a[k] = (in && k <= lane) ? s[tri(i, c0 + k)] : (k == lane ? 1.0f : 0.0f);
  // right-looking: scale column k, then update the columns to its right.
  // Entries above the diagonal (k > lane) are never read as L values. The
  // chain from one pivot to the next is one shuffle: lane k+1 forms its
  // own next diagonal entry before the general update (which gives it the
  // same value). (Passing the scaled column through shared memory as
  // 16-byte broadcasts instead of shuffles was 10 % faster on an NVIDIA
  // H100 80GB HBM3 at 700 W, but spilled registers.)
  float piv = __shfl_sync(kFull, a[0], 0);
  float rdiag = 1.0f;
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const bool pos = piv > 0.0f;  // false for NaN too
    const float rs = pos ? rsqrtf(piv) : nan_f();
    a[k] = lane == k ? piv * rs : a[k] * rs;
    if (lane == k) rdiag = rs;
    if (k + 1 < kNb)
      piv = __shfl_sync(kFull, fmaf(-a[k], a[k], a[k + 1]), k + 1);
#pragma unroll
    for (int j = k + 1; j < kNb; ++j)
      a[j] = fmaf(-a[k], __shfl_sync(kFull, a[k], j), a[j]);
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    if (in && k <= lane) s[tri(i, c0 + k)] = a[k];
    if (ltc != nullptr && k <= lane) ltc[k * kLdt + lane] = a[k];
  }
  dinv[lane] = rdiag;
}

// (2) Rows below the diagonal block, columns c0..c0+31: x L_JJ^T = a, one
// thread per row, right-looking so that each step's updates are
// independent. kStaged reads column j of L_JJ from ltc four entries per
// 16-byte broadcast, and writes row r's solution to column r - c0 - 32 of
// pt (32 rows of ldp), the SYRK's operand; otherwise L_JJ is read entry by
// entry from the packed triangle.
template <bool kStaged>
__device__ __forceinline__ void solve_rows(float* s, const float* dinv,
                                           const float* ltc, float* pt,
                                           int ldp, int c0, int b, int tid) {
  const int c1 = c0 + kNb;
  for (int r = c1 + tid; r < b; r += kDiagThreads) {
    float* row = s + tri(r, c0);
    float x[kNb];
#pragma unroll
    for (int k = 0; k < kNb; ++k) x[k] = row[k];
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      x[j] *= dinv[j];
      if constexpr (kStaged) {
#pragma unroll
        for (int l4 = (j + 1) / 4 * 4; l4 < kNb; l4 += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(ltc + j * kLdt + l4);
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (l4 + e > j) x[l4 + e] = fmaf(-x[j], w[e], x[l4 + e]);
        }
      } else {
#pragma unroll
        for (int l = j + 1; l < kNb; ++l)
          x[l] = fmaf(-x[j], s[tri(c0 + l, c0 + j)], x[l]);
      }
    }
#pragma unroll
    for (int k = 0; k < kNb; ++k) row[k] = x[k];
    if constexpr (kStaged) {
#pragma unroll
      for (int k = 0; k < kNb; ++k) pt[k * ldp + r - c1] = x[k];
    }
  }
}

// (3) Trailing triangle rows/cols c0+32..b-1 -= P P^T with P their columns
// c0..c0+31, in 4 x 4 register tiles over the lower triangle of tiles.
// Neighbouring threads take neighbouring row tiles of one column tile: the
// column operand is a broadcast and the row operands are contiguous.
// kStaged reads P from the transposed copy pt, 4 operands per 16-byte load
// (8 multiply-adds per load); otherwise from the packed triangle, one
// operand per load, rows past b clamped to b-1 (their outputs are not
// stored). 8 x 8 tiles were slower at b=256: too few tiles to fill the
// CTA once the trailing triangle shrinks.
template <bool kStaged>
__device__ __forceinline__ void syrk_trailing(float* s, const float* pt,
                                              int ldp, int c0, int b,
                                              int tid) {
  constexpr int T = 4;
  const int c1 = c0 + kNb;
  if (c1 >= b) return;
  const int nt = (b - c1 + T - 1) / T;
  const int ntiles = nt * (nt + 1) / 2;
  for (int idx = tid; idx < ntiles; idx += kDiagThreads) {
    // idx -> (u, v), u >= v, row-major; tile (ti, tj) = (nt-1-v, nt-1-u)
    int u = (int)((sqrtf(8.0f * (float)idx + 1.0f) - 1.0f) * 0.5f);
    while (u * (u + 1) / 2 > idx) --u;
    while ((u + 1) * (u + 2) / 2 <= idx) ++u;
    const int ti = nt - 1 - (idx - u * (u + 1) / 2);
    const int tj = nt - 1 - u;
    const int i0 = c1 + T * ti;
    const int j0 = c1 + T * tj;
    float acc[T][T];
#pragma unroll
    for (int p = 0; p < T; ++p)
#pragma unroll
      for (int q = 0; q < T; ++q) acc[p][q] = 0.0f;
    if constexpr (kStaged) {
      const float* pi = pt + T * ti;
      const float* pj = pt + T * tj;
#pragma unroll 4
      for (int k = 0; k < kNb; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(pi + k * ldp);
        const float4 yv = *reinterpret_cast<const float4*>(pj + k * ldp);
        const float x[T] = {xv.x, xv.y, xv.z, xv.w};
        const float y[T] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int q = 0; q < T; ++q) acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
      }
    } else {
      int oi[T], oj[T];
#pragma unroll
      for (int q = 0; q < T; ++q) {
        oi[q] = tri(min(i0 + q, b - 1), c0);
        oj[q] = tri(min(j0 + q, b - 1), c0);
      }
#pragma unroll 8
      for (int k = 0; k < kNb; ++k) {
        float x[T], y[T];
#pragma unroll
        for (int q = 0; q < T; ++q) {
          x[q] = s[oi[q] + k];
          y[q] = s[oj[q] + k];
        }
#pragma unroll
        for (int p = 0; p < T; ++p)
#pragma unroll
          for (int q = 0; q < T; ++q) acc[p][q] = fmaf(x[p], y[q], acc[p][q]);
      }
    }
#pragma unroll
    for (int p = 0; p < T; ++p) {
      const int i = i0 + p;
      if (i >= b) continue;
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int j = j0 + q;
        if (j <= i) s[tri(i, j)] -= acc[p][q];
      }
    }
  }
}

// The blocked factorization of the packed triangle s, sub-panel by
// sub-panel; lap(p) adds the time since the last lap to phase p.
template <bool kStaged, class Lap>
__device__ __forceinline__ void factor_blocked(float* s, float* dinv,
                                               float* ltc, float* pt, int ldp,
                                               int b, int tid, Lap& lap) {
  for (int c0 = 0; c0 < b; c0 += kNb) {
    if (tid < 32) factor_diag_block(s, dinv, ltc, c0, b, tid);
    __syncthreads();
    lap(1);
    solve_rows<kStaged>(s, dinv, ltc, pt, ldp, c0, b, tid);
    __syncthreads();
    lap(2);
    syrk_trailing<kStaged>(s, pt, ldp, c0, b, tid);
    __syncthreads();
    lap(3);
  }
}

// Shared memory: the packed triangle, then from the next 16-byte boundary
// dinv (32) and, if ldp > 0 (staged), the SYRK's transposed operand
// (32 x ldp floats) and the diagonal block transposed (32 x kLdt).
// stamps (optional, thread 0, clock64 cycles): [0] load, [1] diagonal
// blocks, [2] row solves, [3] trailing updates, [4] store, [5] total
__global__ void __launch_bounds__(kDiagThreads, 1)
panel_diag_kernel(const float* __restrict__ a, float* __restrict__ out, int b,
                  int ldp, long long* __restrict__ stamps) {
  extern __shared__ float s[];  // packed triangle, dinv, pt, ltc
  float* dinv = s + ((b * (b + 1) / 2 + 3) & ~3);  // 16-byte boundary
  float* pt = dinv + kNb;
  float* ltc = pt + kNb * ldp;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int nwarps = kDiagThreads / 32;
  const bool stamp = stamps != nullptr && tid == 0;
  long long t[6] = {0, 0, 0, 0, 0, 0};
  long long t0 = stamp ? clock64() : 0, tl = t0;
  auto lap = [&](int phase) {
    if (stamp) {
      const long long now = clock64();
      t[phase] += now - tl;
      tl = now;
    }
  };

  for (int i = warp; i < b; i += nwarps)
    for (int j = lane; j <= i; j += 32)
      cp_async4(s + tri(i, j), a + (size_t)i * b + j);
  cp_async_wait_all();
  __syncthreads();
  lap(0);

  if (ldp > 0)
    factor_blocked<true>(s, dinv, ltc, pt, ldp, b, tid, lap);
  else
    factor_blocked<false>(s, dinv, nullptr, nullptr, 0, b, tid, lap);

  for (int i = warp; i < b; i += nwarps) {
#pragma unroll 4
    for (int j = lane; j < b; j += 32)
      out[(size_t)i * b + j] = j <= i ? s[tri(i, j)] : 0.0f;
  }
  lap(4);
  if (stamp) {
    t[5] = clock64() - t0;
    for (int p = 0; p < 6; ++p) stamps[p] = t[p];
  }
}

// out[b + row0 + r][:] = X with X L00^T = B, for the kRows rows of B from
// row0; L00 is read from out[0:b] (written by panel_diag_kernel).
__global__ void __launch_bounds__(kApplyThreads)
panel_apply_kernel(const float* __restrict__ a, float* __restrict__ out, int m,
                   int b) {
  extern __shared__ float4 smem4[];
  const int bp = (b + kNb - 1) / kNb * kNb;
  const int ld = bp + 4;  // == 4 (mod 32): conflict-free 16-byte row reads
  float* xs = reinterpret_cast<float*>(smem4);  // [kRows][ld]: B, then X
  float* ls = xs + kRows * ld;                   // [kNb][ld]: L00 rows
  float* rdiag = ls + kNb * ld;                  // [kNb]: 1 / L00 diagonal
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int nwarps = kApplyThreads / 32;
  const int row0 = b + blockIdx.x * kRows;
  const int nrows = min(kRows, m - row0);

  for (int r = warp; r < kRows; r += nwarps)
    for (int k = lane; k < bp; k += 32) {
      if (r < nrows && k < b)
        cp_async4(xs + r * ld + k, a + (size_t)(row0 + r) * b + k);
      else
        xs[r * ld + k] = 0.0f;
    }

  // thread tile of the product: rows 2 tr, 2 tr + 1; columns tc + 8 q
  const int tc = tid % 8;
  const int tr = tid / 8;
  for (int c0 = 0; c0 < bp; c0 += kNb) {
    const int kw = c0 + kNb;  // L00 columns this block needs
    __syncthreads();          // the previous block's solve is done with ls
    // rows c0..c0+31 of L00, columns 0..kw-1; rows and columns past b are
    // those of an identity, so padded columns of X solve to zero
    for (int c = warp; c < kNb; c += nwarps) {
      const int g = c0 + c;
      for (int k = lane; k < kw; k += 32) {
        if (g < b && k < b)
          cp_async4(ls + c * ld + k, out + (size_t)g * b + k);
        else
          ls[c * ld + k] = g == k ? 1.0f : 0.0f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (c0 > 0) {
      float acc[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
      for (int k = 0; k < c0; k += 4) {
        float4 xv[2], lv[4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          xv[p] = *reinterpret_cast<const float4*>(xs + (2 * tr + p) * ld + k);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          lv[q] = *reinterpret_cast<const float4*>(ls + (tc + 8 * q) * ld + k);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[p][q] = fmaf(xv[p].x, lv[q].x, acc[p][q]);
            acc[p][q] = fmaf(xv[p].y, lv[q].y, acc[p][q]);
            acc[p][q] = fmaf(xv[p].z, lv[q].z, acc[p][q]);
            acc[p][q] = fmaf(xv[p].w, lv[q].w, acc[p][q]);
          }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xs[(2 * tr + p) * ld + c0 + tc + 8 * q] -= acc[p][q];
      __syncthreads();
    }
    // forward substitution through the 32 x 32 diagonal block, one thread
    // per row (warp 0)
    if (tid < kRows) {
      rdiag[lane] = 1.0f / ls[lane * ld + c0 + lane];
      __syncwarp();
      float* xr = xs + tid * ld + c0;
      float x[kNb];
#pragma unroll
      for (int k = 0; k < kNb; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + k);
        x[k] = v.x;
        x[k + 1] = v.y;
        x[k + 2] = v.z;
        x[k + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        x[j] *= rdiag[j];
#pragma unroll
        for (int l = j + 1; l < kNb; ++l)
          x[l] = fmaf(-x[j], ls[l * ld + c0 + j], x[l]);
      }
#pragma unroll
      for (int k = 0; k < kNb; k += 4)
        *reinterpret_cast<float4*>(xr + k) =
            make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
    }
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += nwarps) {
#pragma unroll 4
    for (int k = lane; k < b; k += 32)
      out[(size_t)(row0 + r) * b + k] = xs[r * ld + k];
  }
}

}  // namespace

// a, out (m, b): contiguous float32 on the current device, m >= b.
// stamps: null, or 6 int64 on the device for panel_diag_kernel's clock64
// phase split. Returns the first cudaError_t of the launches (0 on
// success).
extern "C" int egx_factor_panel(const float* a, float* out, int m, int b,
                                long long* stamps, cudaStream_t stream) {
  // dynamic shared memory: the packed triangle, 1 / diagonal and, where
  // they fit (b <= 309), the SYRK's transposed operand (32 rows of the
  // first sub-panel's trailing width, rounded up to 4) and the transposed
  // diagonal block; the row tile, the L00 rows and 1 / diagonal.
  // egobox_torch/ops/chol_kernel.py refuses a b for which either exceeds
  // the 227 KB a CTA may use.
  constexpr size_t kMaxSmem = 232448;
  const int bp = (b + kNb - 1) / kNb * kNb;
  const size_t base = ((size_t)b * (b + 1) / 2 + 3) / 4 * 4 + kNb;
  int ldp = b > kNb ? (b - kNb + 3) / 4 * 4 : 0;
  size_t dsmem = (base + (size_t)kNb * (ldp + kLdt)) * sizeof(float);
  if (dsmem > kMaxSmem) {
    ldp = 0;
    dsmem = base * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(
      panel_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dsmem);
  if (err != cudaSuccess) return (int)err;
  panel_diag_kernel<<<1, kDiagThreads, dsmem, stream>>>(a, out, b, ldp,
                                                         stamps);
  err = cudaGetLastError();
  if (err != cudaSuccess || m == b) return (int)err;
  const int asmem =
      (int)(((size_t)(kRows + kNb) * (bp + 4) + kNb) * sizeof(float));
  err = cudaFuncSetAttribute(
      panel_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, asmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (m - b + kRows - 1) / kRows;
  panel_apply_kernel<<<grid, kApplyThreads, asmem, stream>>>(a, out, m, b);
  return (int)cudaGetLastError();
}
