// Fused multipole spline evaluation + Legendre combination, f64, for Hopper
// (sm_90a).
//
//   out[b, q] = sum_l S_{b,l}(clamp(x[b / G, q])) * leg[b / G, l, q]
//
// Rows come in groups of G that share one coordinate row: G = 1 on the
// dense path (a coordinate row per row), G = T in the grid-collapse sweep,
// where the T basis terms of one node are evaluated at that node's
// AP-rescaled coordinates (vega_tpu/pktoxi.py:308-320), so the sweep never
// copies coordinates T times.
//
// S_{b,l} is the not-a-knot cubic spline of multipole l of row b, given by
// its knot values y[b, l, :] and second derivatives m[b, l, :] on the knot
// grid `knots` (uniform in log r, shared by all rows). Queries are clamped
// to the knot range; the caller computes the out-of-range flag.
//
// Replaces the Pallas TPU kernels of vega_tpu/ops/pallas_spline.py:
// `spline_legendre_combine` (:123, kernel `_kernel` :82) and
// `spline_legendre_combine_batched` (:186, kernel `_batched_kernel` :169).
// Unlike them it runs in f64, and it picks the interval exactly as
// vega_tpu/ops/spline.py:spline_eval does, round-off guard included
// (:88-92): arithmetic index from the uniform step, then one step down if
// the query lies below knots[j], one step up if it lies at or above
// knots[j+1]. The TPU layout ((8, 128) vreg tables, `_gather_vreg`,
// 1024-query tile padding) does not carry over.
//
// What bounds it: per row, the knot tables are (2L + 1) * N f64 values
// (L = 4, N = 814: 52,096 B of y and m plus 6,512 B of knots), and every
// query reads one x and L Legendre weights and writes one result: 48 B per
// query at L = 4. With 2-3 flops per byte it is memory-bound; the table
// lookups are data-dependent gathers.
//
// Design: one block per row. The block stages the row's tables in shared
// memory once (dynamic shared memory: 58.6 KB is above the 48 KB static
// limit), so every gather hits shared memory and device memory sees each
// table byte once per row; threads then stride over the row's queries,
// one query per thread, so the x / leg / out streams are coalesced. A row
// stride of 0 for x and leg lets rows share coordinates (the unscaled
// smooth component) without copies, as does a group G > 1; rows that share
// coordinates hit L2 for them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spline_legendre_combine_kernel(const double* __restrict__ knots,
                               const double* __restrict__ y,
                               const double* __restrict__ m,
                               const double* __restrict__ x,
                               const double* __restrict__ leg,
                               double* __restrict__ out,
                               int L, int N, int M, int G,
                               long long x_row_stride,
                               long long leg_row_stride,
                               double step) {
  extern __shared__ double smem[];
  double* s_knots = smem;              // (N,)
  double* s_y = smem + N;              // (L, N)
  double* s_m = s_y + (long long)L * N;  // (L, N)

  const long long b = blockIdx.x;
  const long long table = (long long)L * N;
  const double* y_row = y + b * table;
  const double* m_row = m + b * table;
  for (int i = threadIdx.x; i < N; i += blockDim.x) s_knots[i] = knots[i];
  for (long long i = threadIdx.x; i < table; i += blockDim.x) {
    s_y[i] = y_row[i];
    s_m[i] = m_row[i];
  }
  __syncthreads();

  const double x0 = s_knots[0];
  const double xn = s_knots[N - 1];
  const double* x_row = x + (b / G) * x_row_stride;
  const double* leg_row = leg + (b / G) * leg_row_stride;
  double* out_row = out + b * (long long)M;

  for (int q = threadIdx.x; q < M; q += blockDim.x) {
    double xq = x_row[q];
    // clamp; a NaN query stays NaN (as jnp.clip / torch.clamp)
    xq = xq < x0 ? x0 : (xq > xn ? xn : xq);

    int j = (int)((xq - x0) / step);
    j = min(max(j, 0), N - 2);
    if (xq < s_knots[j]) j -= 1;
    if (xq >= s_knots[min(j + 1, N - 1)]) j += 1;
    j = min(max(j, 0), N - 2);

    const double x_lo = s_knots[j];
    const double x_hi = s_knots[j + 1];
    const double h = x_hi - x_lo;
    const double t_hi = (x_hi - xq) / h;
    const double t_lo = (xq - x_lo) / h;
    const double h2 = h * h / 6.0;
    const double c_hi = t_hi * t_hi * t_hi - t_hi;
    const double c_lo = t_lo * t_lo * t_lo - t_lo;

    double acc = 0.0;
    for (int l = 0; l < L; ++l) {
      const double* sy = s_y + (long long)l * N;
      const double* sm = s_m + (long long)l * N;
      const double v = sy[j] * t_hi + sy[j + 1] * t_lo
                       + sm[j] * h2 * c_hi + sm[j + 1] * h2 * c_lo;
      acc += v * leg_row[(long long)l * M + q];
    }
    out_row[q] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t). Does not synchronise.
// Returns cudaGetLastError() after the launch: non-zero means the launch
// was refused or an earlier asynchronous fault surfaced.
int vega_spline_legendre_combine_f64(const double* knots, const double* y,
                                     const double* m, const double* x,
                                     const double* leg, double* out,
                                     int B, int L, int N, int M, int G,
                                     long long x_row_stride,
                                     long long leg_row_stride, double step,
                                     void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (G <= 0 || B % G != 0) return (int)cudaErrorInvalidValue;
  // the row's knots, y and m tables
  const long long smem = (2LL * L + 1) * N * (long long)sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      spline_legendre_combine_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spline_legendre_combine_kernel<<<B, kThreads, (size_t)smem,
                                   (cudaStream_t)stream>>>(
      knots, y, m, x, leg, out, L, N, M, G, x_row_stride, leg_row_stride,
      step);
  return (int)cudaGetLastError();
}

const char* vega_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
