// Fused multipole spline evaluation + Legendre combination, its
// derivatives and its transpose, f64, for Hopper (sm_90a).
//
//   F_d[b, q]    = sum_l S^(d)_{b,l}(clamp(x[b / G, q])) * leg[b / G, l, q]
//   P_d[b, l, q] = S^(d)_{b,l}(clamp(x[b / G, q]))
//   Ft_d(g, x, leg) = (Ybar, Mbar), each (B, L, N): the adjoint of
//                  (y, m) -> F_d, a scatter-add into the knot tables
//
// Rows come in groups of G that share one coordinate row: G = 1 on the
// dense path (a coordinate row per row), G = T in the grid-collapse sweep,
// where the T basis terms of one node are evaluated at that node's
// AP-rescaled coordinates (vega_tpu/pktoxi.py:308-320), so the sweep never
// copies coordinates T times. The transpose serves gradients only, which
// take G = 1.
//
// S_{b,l} is the not-a-knot cubic spline of multipole l of row b, given by
// its knot values y[b, l, :] and second derivatives m[b, l, :] on the knot
// grid `knots` (uniform in log r, shared by all rows); S^(d) is its d-th
// derivative in x, d = 0..3 (a template parameter), linear in (y, m) with
// weights that depend on the query's place in its interval. S^(3) is
// constant on each interval. Queries are clamped to the knot range; the
// caller computes the out-of-range flag and the clamp's derivative.
//
// Replaces the Pallas TPU kernels of vega_tpu/ops/pallas_spline.py:
// `spline_legendre_combine` (:123, kernel `_kernel` :82) and
// `spline_legendre_combine_batched` (:186, kernel `_batched_kernel` :169),
// which are F_0; F_d (d >= 1), P_d and Ft_d replace the backward of
// `make_vmappable_combine` (:233, custom_vjp :278-290), the XLA VJP of
// `spline_eval` that vega_tpu differentiates twice for its Hessian. Unlike
// them this runs in f64, and it picks the interval exactly as
// vega_tpu/ops/spline.py:spline_eval does, round-off guard included
// (:88-92): arithmetic index from the uniform step, then one step down if
// the query lies below knots[j], one step up if it lies at or above
// knots[j+1]. The gradient of a query on a knot lands in that interval's
// slots, as in the plain version. The TPU layout ((8, 128) vreg tables,
// `_gather_vreg`, 1024-query tile padding) does not carry over.
//
// What bounds them: per row, the knot tables are (2L + 1) * N f64 values
// (L = 4, N = 814: 52,096 B of y and m plus 6,512 B of knots), and every
// query reads one x and L Legendre weights and writes one result (L with
// P_d): 48 B per query at L = 4. With 2-3 flops per byte they are
// memory-bound; the table lookups are data-dependent gathers, and the
// transpose's updates data-dependent scatters.
//
// Design: one block per row. The forward block stages the row's tables in
// shared memory once (dynamic shared memory: 58.6 KB is above the 48 KB
// static limit), so every gather hits shared memory and device memory sees
// each table byte once per row; threads then stride over the row's
// queries, one query per thread, so the x / leg / out streams are
// coalesced. A row stride of 0 for x and leg lets rows share coordinates
// (the unscaled smooth component) without copies, as does a group G > 1;
// rows that share coordinates hit L2 for them. The transpose block keeps
// the row's two (L, N) gradient tables in shared memory, zeroed, adds each
// query's four weighted contributions per multipole with f64 atomicAdd on
// shared memory, and writes each table once, coalesced. Queries cluster in
// few intervals at large r (the r grid is dense there), so the atomics
// contend within a row; the order in which they land is not fixed, so Ft_d
// may differ from run to run in the last bits (compare with relative
// tolerances, never bit for bit).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The query's interval j (the guarded choice of spline_eval) and the
// weights of y[j], y[j+1], m[j], m[j+1] in S^(D) at the clamped query;
// ops/spline.py:piece_weights computes the same expressions.
struct Piece {
  int j;
  double w_ylo, w_yhi, w_mlo, w_mhi;
};

template <int D>
__device__ __forceinline__ Piece piece_at(const double* s_knots, int N,
                                          double step, double xq) {
  const double x0 = s_knots[0];
  const double xn = s_knots[N - 1];
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
  Piece p;
  p.j = j;
  if (D == 0) {
    const double h2 = h * h / 6.0;
    p.w_ylo = t_hi;
    p.w_yhi = t_lo;
    p.w_mlo = h2 * (t_hi * t_hi * t_hi - t_hi);
    p.w_mhi = h2 * (t_lo * t_lo * t_lo - t_lo);
  } else if (D == 1) {
    p.w_ylo = -1.0 / h;
    p.w_yhi = 1.0 / h;
    p.w_mlo = -h * (3.0 * t_hi * t_hi - 1.0) / 6.0;
    p.w_mhi = h * (3.0 * t_lo * t_lo - 1.0) / 6.0;
  } else if (D == 2) {
    p.w_ylo = 0.0;
    p.w_yhi = 0.0;
    p.w_mlo = t_hi;
    p.w_mhi = t_lo;
  } else {
    p.w_ylo = 0.0;
    p.w_yhi = 0.0;
    p.w_mlo = -1.0 / h;
    p.w_mhi = 1.0 / h;
  }
  return p;
}

// F_D (kSum, out (B, M)) or P_D (!kSum, out (B, L, M); leg unused).
template <int D, bool kSum>
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
  double* s_knots = smem;                // (N,)
  double* s_y = smem + N;                // (L, N)
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

  const double* x_row = x + (b / G) * x_row_stride;
  const double* leg_row = kSum ? leg + (b / G) * leg_row_stride : nullptr;

  for (int q = threadIdx.x; q < M; q += blockDim.x) {
    const Piece p = piece_at<D>(s_knots, N, step, x_row[q]);
    double acc = 0.0;
    for (int l = 0; l < L; ++l) {
      const double* sy = s_y + (long long)l * N;
      const double* sm = s_m + (long long)l * N;
      const double v = sy[p.j] * p.w_ylo + sy[p.j + 1] * p.w_yhi
                       + sm[p.j] * p.w_mlo + sm[p.j + 1] * p.w_mhi;
      if (kSum) {
        acc += v * leg_row[(long long)l * M + q];
      } else {
        out[(b * L + l) * (long long)M + q] = v;
      }
    }
    if (kSum) out[b * (long long)M + q] = acc;
  }
}

// Ft_D: out_y[b, l, i] = sum_q g[b, q] leg[b, l, q] dS^(D)(x_q) / dy[b, l, i],
// out_m the same for m; g (B, M) contiguous, G = 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
spline_legendre_combine_transpose_kernel(const double* __restrict__ knots,
                                         const double* __restrict__ g,
                                         const double* __restrict__ x,
                                         const double* __restrict__ leg,
                                         double* __restrict__ out_y,
                                         double* __restrict__ out_m,
                                         int L, int N, int M,
                                         long long x_row_stride,
                                         long long leg_row_stride,
                                         double step) {
  extern __shared__ double smem[];
  double* s_knots = smem;                 // (N,)
  double* s_gy = smem + N;                // (L, N)
  double* s_gm = s_gy + (long long)L * N;  // (L, N)

  const long long b = blockIdx.x;
  const long long table = (long long)L * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) s_knots[i] = knots[i];
  for (long long i = threadIdx.x; i < table; i += blockDim.x) {
    s_gy[i] = 0.0;
    s_gm[i] = 0.0;
  }
  __syncthreads();

  const double* x_row = x + b * x_row_stride;
  const double* leg_row = leg + b * leg_row_stride;
  const double* g_row = g + b * (long long)M;
  for (int q = threadIdx.x; q < M; q += blockDim.x) {
    const Piece p = piece_at<D>(s_knots, N, step, x_row[q]);
    const double gq = g_row[q];
    for (int l = 0; l < L; ++l) {
      const double c = gq * leg_row[(long long)l * M + q];
      double* gy = s_gy + (long long)l * N;
      double* gm = s_gm + (long long)l * N;
      if (D < 2) {  // S^(2) and S^(3) do not read y
        atomicAdd(gy + p.j, c * p.w_ylo);
        atomicAdd(gy + p.j + 1, c * p.w_yhi);
      }
      atomicAdd(gm + p.j, c * p.w_mlo);
      atomicAdd(gm + p.j + 1, c * p.w_mhi);
    }
  }
  __syncthreads();

  double* y_row = out_y + b * table;
  double* m_row = out_m + b * table;
  for (long long i = threadIdx.x; i < table; i += blockDim.x) {
    y_row[i] = s_gy[i];
    m_row[i] = s_gm[i];
  }
}

// knots plus two (L, N) tables per block
long long table_smem(int L, int N) {
  return (2LL * L + 1) * N * (long long)sizeof(double);
}

template <int D, bool kSum>
cudaError_t launch_combine(const double* knots, const double* y,
                           const double* m, const double* x,
                           const double* leg, double* out, int B, int L,
                           int N, int M, int G, long long x_row_stride,
                           long long leg_row_stride, double step,
                           cudaStream_t stream) {
  const long long smem = table_smem(L, N);
  void (*kernel)(const double*, const double*, const double*,
                 const double*, const double*, double*, int, int, int, int,
                 long long, long long, double) =
      spline_legendre_combine_kernel<D, kSum>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spline_legendre_combine_kernel<D, kSum><<<B, kThreads, (size_t)smem,
                                            stream>>>(
      knots, y, m, x, leg, out, L, N, M, G, x_row_stride, leg_row_stride,
      step);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_transpose(const double* knots, const double* g,
                             const double* x, const double* leg,
                             double* out_y, double* out_m, int B, int L,
                             int N, int M, long long x_row_stride,
                             long long leg_row_stride, double step,
                             cudaStream_t stream) {
  const long long smem = table_smem(L, N);
  void (*kernel)(const double*, const double*, const double*,
                 const double*, double*, double*, int, int, int, long long,
                 long long, double) =
      spline_legendre_combine_transpose_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spline_legendre_combine_transpose_kernel<D><<<B, kThreads, (size_t)smem,
                                                stream>>>(
      knots, g, x, leg, out_y, out_m, L, N, M, x_row_stride, leg_row_stride,
      step);
  return cudaGetLastError();
}

template <bool kSum>
int dispatch_combine(const double* knots, const double* y, const double* m,
                     const double* x, const double* leg, double* out, int B,
                     int L, int N, int M, int G, long long x_row_stride,
                     long long leg_row_stride, double step, int order,
                     void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (G <= 0 || B % G != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 0: return (int)launch_combine<0, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, s);
    case 1: return (int)launch_combine<1, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, s);
    case 2: return (int)launch_combine<2, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, s);
    case 3: return (int)launch_combine<3, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each launches its kernel on `stream` (a cudaStream_t) and does not
// synchronise. Each returns cudaGetLastError() after the launch: non-zero
// means the launch was refused or an earlier asynchronous fault surfaced.
// `order` is the derivative order d, 0..3.

// F_d: out (B, M).
int vega_spline_legendre_combine_f64(const double* knots, const double* y,
                                     const double* m, const double* x,
                                     const double* leg, double* out,
                                     int B, int L, int N, int M, int G,
                                     long long x_row_stride,
                                     long long leg_row_stride, double step,
                                     int order, void* stream) {
  return dispatch_combine<true>(knots, y, m, x, leg, out, B, L, N, M, G,
                                x_row_stride, leg_row_stride, step, order,
                                stream);
}

// P_d: out (B, L, M).
int vega_spline_legendre_points_f64(const double* knots, const double* y,
                                    const double* m, const double* x,
                                    double* out, int B, int L, int N, int M,
                                    int G, long long x_row_stride,
                                    double step, int order, void* stream) {
  return dispatch_combine<false>(knots, y, m, x, nullptr, out, B, L, N, M,
                                 G, x_row_stride, 0, step, order, stream);
}

// Ft_d: out_y, out_m (B, L, N), every entry written.
int vega_spline_legendre_transpose_f64(const double* knots, const double* g,
                                       const double* x, const double* leg,
                                       double* out_y, double* out_m, int B,
                                       int L, int N, int M,
                                       long long x_row_stride,
                                       long long leg_row_stride, double step,
                                       int order, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 0: return (int)launch_transpose<0>(
        knots, g, x, leg, out_y, out_m, B, L, N, M, x_row_stride,
        leg_row_stride, step, s);
    case 1: return (int)launch_transpose<1>(
        knots, g, x, leg, out_y, out_m, B, L, N, M, x_row_stride,
        leg_row_stride, step, s);
    case 2: return (int)launch_transpose<2>(
        knots, g, x, leg, out_y, out_m, B, L, N, M, x_row_stride,
        leg_row_stride, step, s);
    case 3: return (int)launch_transpose<3>(
        knots, g, x, leg, out_y, out_m, B, L, N, M, x_row_stride,
        leg_row_stride, step, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vega_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
