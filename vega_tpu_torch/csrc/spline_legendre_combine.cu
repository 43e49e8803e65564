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
// What bounds them: per row, the knot tables are 2 L N f64 values (L = 4,
// N = 814: 52,096 B of y and m), and every query reads one x and L
// Legendre weights and writes one result (L with P_d): 48 B per query at
// L = 4, against about 60 flops. The card's f64 ridge is 34 TFLOP/s over
// 3.35 TB/s, about 10 flops per byte, so every layout is bound by memory:
// at large B by HBM bytes, at B = 1 (every launch of a fit) by latency,
// since one row's 5000 queries are a few microseconds of work.
//
// Design. The host splits each row's M queries into `tiles` tiles of
// `tile_q` queries (ops/spline_combine.py:launch_plan): one tile per row
// once B fills the card twice over (B >= 264 blocks), about 20 tiles of
// 256 queries at B = 1, M = 5000, so a fit's launches spread over 20 SMs
// instead of walking 5000 queries on one. A block is one (row, tile).
//
// Forward (F_d, P_d): the block stages the row's tables (m, and y where
// S^(d) reads it: d < 2) in shared memory with cp.async, so the copy runs
// while the threads load their first queries' coordinates and pick their
// intervals; they wait on it only before the first gather. The knots are
// read through the read-only path, not staged, and the guard's four
// candidate knots are loaded together, so a block takes 52 KB of shared
// memory (26 KB for d >= 2): four blocks fit on an SM. One query per
// thread, so the x / leg / out streams are coalesced. A row stride of 0
// for x and leg lets rows share coordinates without copies, as does a
// group G > 1. A kernel's shared-memory attributes are set once per
// device (again only for a launch that needs more than the ones before),
// not at every launch: at B = 1 the host's time per launch is what a fit
// waits on.
//
// Transpose (Ft_d): no atomics. The block walks its tile in chunks of 256
// queries. Each thread puts its query's four weights and its L
// coefficients g * leg_l in shared memory and its interval j in a block
// radix sort (cub::BlockRadixSort, stable: keys j, values the query's
// place in the chunk). The last query of each run of one interval then
// sums the run's contributions, in sorted order, for every multipole, and
// adds the slot-j sums into the tile's (L, N) tables in shared memory;
// after a barrier it adds the slot-j+1 sums. Each run owns its j, so no
// two threads add into one slot. The tile's tables go out once,
// coalesced: straight into (Ybar, Mbar) when a row is one tile, else into
// (B, tiles, 2, L, N) scratch that a second small kernel sums over the
// tiles in order. Every sum is taken in a fixed order: Ft_d is bitwise
// reproducible from run to run.

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 8;          // multipoles a launch may have
constexpr int kMaxDevices = 16;   // devices whose attributes are cached

// The query's interval j (the guarded choice of spline_eval) and the
// weights of y[j], y[j+1], m[j], m[j+1] in S^(D) at the clamped query;
// ops/spline.py:piece_weights computes the same expressions. x0 and xn
// are knots[0] and knots[N - 1].
struct Piece {
  int j;
  double w_ylo, w_yhi, w_mlo, w_mhi;
};

template <int D>
__device__ __forceinline__ Piece piece_at(const double* __restrict__ knots,
                                          int N, double x0, double xn,
                                          double step, double xq) {
  // clamp; a NaN query stays NaN (as jnp.clip / torch.clamp)
  xq = xq < x0 ? x0 : (xq > xn ? xn : xq);

  int j0 = (int)((xq - x0) / step);
  j0 = min(max(j0, 0), N - 2);
  // the guard's candidates, knots[j0 - 1 .. j0 + 2], loaded together
  const double k_m1 = __ldg(knots + max(j0 - 1, 0));
  const double k_0 = __ldg(knots + j0);
  const double k_p1 = __ldg(knots + j0 + 1);
  const double k_p2 = __ldg(knots + min(j0 + 2, N - 1));
  int j = j0;
  if (xq < k_0) j -= 1;
  if (xq >= (j == j0 ? k_p1 : k_0)) j += 1;   // knots[min(j + 1, N - 1)]
  j = min(max(j, 0), N - 2);

  const double x_lo = j < j0 ? k_m1 : (j == j0 ? k_0 : k_p1);
  const double x_hi = j < j0 ? k_0 : (j == j0 ? k_p1 : k_p2);
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

// n doubles from global to shared memory, asynchronously (8-byte
// cp.async: the tables need only the alignment of a double)
__device__ __forceinline__ void stage_async(double* dst,
                                            const double* __restrict__ src,
                                            long long n) {
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src + i) : "memory");
  }
}

// F_D (kSum, out (B, M)) or P_D (!kSum, out (B, L, M); leg unused); a
// query per thread at a time. Block = (row, tile).
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
                               long long leg_row_stride, double step,
                               int tiles, int tile_q) {
  constexpr bool kReadsY = D < 2;   // S'' and S''' do not read y
  extern __shared__ double smem[];
  const long long table = (long long)L * N;
  double* s_m = smem;               // (L, N)
  double* s_y = smem + table;       // (L, N), d < 2 only

  const long long b = blockIdx.x / tiles;
  const int q_begin = (blockIdx.x % tiles) * tile_q;
  const int q_end = min(M, q_begin + tile_q);
  stage_async(s_m, m + b * table, table);
  if (kReadsY) stage_async(s_y, y + b * table, table);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const double x0 = __ldg(knots);
  const double xn = __ldg(knots + N - 1);
  const double* x_row = x + (b / G) * x_row_stride;
  const double* leg_row = kSum ? leg + (b / G) * leg_row_stride : nullptr;

  bool staged = false;
  for (int q = q_begin + threadIdx.x;; q += kThreads) {
    const bool active = q < q_end;
    Piece p;
    if (active) p = piece_at<D>(knots, N, x0, xn, step, __ldg(x_row + q));
    if (!staged) {  // every thread passes here once, active or not
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      staged = true;
    }
    if (!active) break;

    const int j = p.j;
    double acc = 0.0;
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      if (l >= L) break;
      const double* sy = s_y + (long long)l * N;
      const double* sm = s_m + (long long)l * N;
      double v;
      if constexpr (kReadsY) {
        v = sy[j] * p.w_ylo + sy[j + 1] * p.w_yhi + sm[j] * p.w_mlo
            + sm[j + 1] * p.w_mhi;
      } else {
        v = sm[j] * p.w_mlo + sm[j + 1] * p.w_mhi;
      }
      if (kSum) {
        acc += v * __ldg(leg_row + (long long)l * M + q);
      } else {
        out[(b * L + l) * (long long)M + q] = v;
      }
    }
    if (kSum) out[b * (long long)M + q] = acc;
  }
}

// Ft_D of one (row, tile): the tile's share of out_y[b, l, i] = sum_q
// g[b, q] leg[b, l, q] dS^(D)(x_q) / dy[b, l, i] (and out_m the same for
// m), written to dst_y / dst_m + (b * tiles + tile) * dst_stride; g
// (B, M) contiguous, G = 1. key_bits: bits of N - 1.
template <int D>
__global__ void __launch_bounds__(kThreads)
spline_legendre_combine_transpose_kernel(const double* __restrict__ knots,
                                         const double* __restrict__ g,
                                         const double* __restrict__ x,
                                         const double* __restrict__ leg,
                                         double* __restrict__ dst_y,
                                         double* __restrict__ dst_m,
                                         long long dst_stride,
                                         int L, int N, int M,
                                         long long x_row_stride,
                                         long long leg_row_stride,
                                         double step, int tiles, int tile_q,
                                         int key_bits) {
  constexpr bool kReadsY = D < 2;   // S'' and S''' do not read y
  using Sort = cub::BlockRadixSort<unsigned, kThreads, 1, int>;
  __shared__ typename Sort::TempStorage sort_storage;
  extern __shared__ double smem[];
  const long long table = (long long)L * N;
  double* t_y = smem;                       // (L, N) this tile's Ybar
  double* t_m = smem + table;               // (L, N) this tile's Mbar
  // per query of the chunk: w_ylo, w_yhi, w_mlo, w_mhi, g * leg_l
  double* stash = t_m + table;              // (4 + L, kThreads)
  int* s_j = reinterpret_cast<int*>(stash + (4 + L) * kThreads);
  int* s_q = s_j + kThreads;                // sorted j, place in the chunk

  const long long b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int q_begin = tile * tile_q;
  const int q_end = min(M, q_begin + tile_q);
  for (long long i = threadIdx.x; i < 2 * table; i += kThreads)
    smem[i] = 0.0;

  const double x0 = __ldg(knots);
  const double xn = __ldg(knots + N - 1);
  const double* x_row = x + b * x_row_stride;
  const double* leg_row = leg + b * leg_row_stride;
  const double* g_row = g + b * (long long)M;
  const int t = threadIdx.x;
  for (int chunk = q_begin; chunk < q_end; chunk += kThreads) {
    const int q = chunk + t;
    unsigned key[1] = {(unsigned)(N - 1)};  // past every interval: no owner
    int place[1] = {t};
    if (q < q_end) {
      const Piece p = piece_at<D>(knots, N, x0, xn, step, __ldg(x_row + q));
      const double gq = __ldg(g_row + q);
      stash[t] = p.w_ylo;
      stash[kThreads + t] = p.w_yhi;
      stash[2 * kThreads + t] = p.w_mlo;
      stash[3 * kThreads + t] = p.w_mhi;
      for (int l = 0; l < L; ++l)
        stash[(4 + l) * kThreads + t] =
            gq * __ldg(leg_row + (long long)l * M + q);
      key[0] = (unsigned)p.j;
    }
    Sort(sort_storage).Sort(key, place, 0, key_bits);
    const int j = (int)key[0];
    s_j[t] = j;
    s_q[t] = place[0];
    __syncthreads();

    // the last query of each run of one j sums the run (sorted order)
    const bool owner = j < N - 1 && (t == kThreads - 1 || s_j[t + 1] != j);
    double sums[4][kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      sums[0][l] = sums[1][l] = sums[2][l] = sums[3][l] = 0.0;
    if (owner) {
      for (int r = t; r >= 0 && s_j[r] == j; --r) {
        const int i = s_q[r];
        const double w_ylo = stash[i];
        const double w_yhi = stash[kThreads + i];
        const double w_mlo = stash[2 * kThreads + i];
        const double w_mhi = stash[3 * kThreads + i];
#pragma unroll
        for (int l = 0; l < kMaxL; ++l) {
          if (l >= L) break;
          const double c = stash[(4 + l) * kThreads + i];
          if (kReadsY) {
            sums[0][l] += c * w_ylo;
            sums[1][l] += c * w_yhi;
          }
          sums[2][l] += c * w_mlo;
          sums[3][l] += c * w_mhi;
        }
      }
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l >= L) break;
        if (kReadsY) t_y[(long long)l * N + j] += sums[0][l];
        t_m[(long long)l * N + j] += sums[2][l];
      }
    }
    __syncthreads();   // slot j + 1 may be another run's slot j
    if (owner) {
#pragma unroll
      for (int l = 0; l < kMaxL; ++l) {
        if (l >= L) break;
        if (kReadsY) t_y[(long long)l * N + j + 1] += sums[1][l];
        t_m[(long long)l * N + j + 1] += sums[3][l];
      }
    }
    __syncthreads();   // before the next chunk reuses the stash
  }
  __syncthreads();

  double* out_y = dst_y + (b * tiles + tile) * dst_stride;
  double* out_m = dst_m + (b * tiles + tile) * dst_stride;
  for (long long i = t; i < table; i += kThreads) {
    out_y[i] = t_y[i];
    out_m[i] = t_m[i];
  }
}

// (out_y, out_m)[b] = sum over tiles, in order, of scratch[b, tile]
// ((B, tiles, 2, L, N): the transpose kernel's partial tables)
__global__ void __launch_bounds__(kThreads)
sum_tiles_kernel(const double* __restrict__ scratch,
                 double* __restrict__ out_y, double* __restrict__ out_m,
                 int B, long long table, int tiles) {
  const long long per_row = 2 * table;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= B * per_row) return;
  const long long b = i / per_row;
  const long long r = i % per_row;
  const double* src = scratch + b * tiles * per_row + r;
  double s = src[0];
  for (int tile = 1; tile < tiles; ++tile) s += src[tile * per_row];
  (r < table ? out_y + b * table + r : out_m + b * table + r - table)[0] = s;
}

// Let `kernel` take `smem` bytes of dynamic shared memory, preferring
// shared memory to L1, unless an earlier launch on this device already
// allowed as much: `granted` is the kernel's own record per device (a
// static of its launcher), so only a launch that needs more than the
// ones before it sets the attributes.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem, long long* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && cached) granted[dev] = smem;
  return err;
}

template <int D, bool kSum>
cudaError_t launch_combine(const double* knots, const double* y,
                           const double* m, const double* x,
                           const double* leg, double* out, int B, int L,
                           int N, int M, int G, long long x_row_stride,
                           long long leg_row_stride, double step, int tiles,
                           int tile_q, cudaStream_t stream) {
  static long long granted[kMaxDevices] = {};
  const long long smem =
      (D < 2 ? 2LL : 1LL) * L * N * (long long)sizeof(double);
  auto kernel = spline_legendre_combine_kernel<D, kSum>;
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  kernel<<<B * tiles, kThreads, (size_t)smem, stream>>>(
      knots, y, m, x, leg, out, L, N, M, G, x_row_stride, leg_row_stride,
      step, tiles, tile_q);
  return cudaGetLastError();
}

// the launch plan must cover the row and fit in a grid
bool bad_plan(int B, int L, int M, int tiles, int tile_q) {
  return L < 1 || L > kMaxL || tiles < 1 || tile_q < 1 ||
         (long long)tiles * tile_q < M ||
         (long long)(tiles - 1) * tile_q >= (M > 0 ? M : 1) ||
         (long long)B * tiles > 0x7fffffffLL;
}

template <bool kSum>
int dispatch_combine(const double* knots, const double* y, const double* m,
                     const double* x, const double* leg, double* out, int B,
                     int L, int N, int M, int G, int tiles, int tile_q,
                     long long x_row_stride, long long leg_row_stride,
                     double step, int order, void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (G <= 0 || B % G != 0 || bad_plan(B, L, M, tiles, tile_q))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 0: return (int)launch_combine<0, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, tiles, tile_q, s);
    case 1: return (int)launch_combine<1, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, tiles, tile_q, s);
    case 2: return (int)launch_combine<2, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, tiles, tile_q, s);
    case 3: return (int)launch_combine<3, kSum>(
        knots, y, m, x, leg, out, B, L, N, M, G, x_row_stride,
        leg_row_stride, step, tiles, tile_q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_transpose(const double* knots, const double* g,
                             const double* x, const double* leg,
                             double* out_y, double* out_m, double* scratch,
                             int B, int L, int N, int M, int tiles,
                             int tile_q, long long x_row_stride,
                             long long leg_row_stride, double step,
                             cudaStream_t stream) {
  static long long granted[kMaxDevices] = {};
  const long long table = (long long)L * N;
  const long long smem = (2 * table + (4LL + L) * kThreads) * sizeof(double)
                         + 2LL * kThreads * sizeof(int);
  int key_bits = 1;
  while ((1LL << key_bits) < N) ++key_bits;   // N - 1 < 2^key_bits
  auto kernel = spline_legendre_combine_transpose_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  // one tile per row: straight into the outputs; else partial tables
  // (scratch, (B, tiles, 2, L, N)) summed in tile order by a second kernel
  double* dst_y = tiles == 1 ? out_y : scratch;
  double* dst_m = tiles == 1 ? out_m : scratch + table;
  const long long dst_stride = tiles == 1 ? table : 2 * table;
  kernel<<<B * tiles, kThreads, (size_t)smem, stream>>>(
      knots, g, x, leg, dst_y, dst_m, dst_stride, L, N, M, x_row_stride,
      leg_row_stride, step, tiles, tile_q, key_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  const long long n = (long long)B * 2 * table;
  sum_tiles_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     stream>>>(scratch, out_y, out_m, B, table, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches its kernel(s) on `stream` (a cudaStream_t) and does not
// synchronise. Each returns cudaGetLastError() after its launches:
// non-zero means a launch was refused or an earlier asynchronous fault
// surfaced. `order` is the derivative order d, 0..3; (tiles, tile_q) is
// the launch plan: each row's M queries in `tiles` tiles of tile_q.

// F_d: out (B, M).
int vega_spline_legendre_combine_f64(const double* knots, const double* y,
                                     const double* m, const double* x,
                                     const double* leg, double* out,
                                     int B, int L, int N, int M, int G,
                                     int tiles, int tile_q,
                                     long long x_row_stride,
                                     long long leg_row_stride, double step,
                                     int order, void* stream) {
  return dispatch_combine<true>(knots, y, m, x, leg, out, B, L, N, M, G,
                                tiles, tile_q, x_row_stride, leg_row_stride,
                                step, order, stream);
}

// P_d: out (B, L, M).
int vega_spline_legendre_points_f64(const double* knots, const double* y,
                                    const double* m, const double* x,
                                    double* out, int B, int L, int N, int M,
                                    int G, int tiles, int tile_q,
                                    long long x_row_stride, double step,
                                    int order, void* stream) {
  return dispatch_combine<false>(knots, y, m, x, nullptr, out, B, L, N, M,
                                 G, tiles, tile_q, x_row_stride, 0, step,
                                 order, stream);
}

// Ft_d: out_y, out_m (B, L, N), every entry written; scratch (B, tiles,
// 2, L, N) when tiles > 1 (unused, may be null, when tiles == 1).
int vega_spline_legendre_transpose_f64(const double* knots, const double* g,
                                       const double* x, const double* leg,
                                       double* out_y, double* out_m,
                                       double* scratch, int B, int L, int N,
                                       int M, int tiles, int tile_q,
                                       long long x_row_stride,
                                       long long leg_row_stride, double step,
                                       int order, void* stream) {
  if (B <= 0) return 0;
  if (bad_plan(B, L, M, tiles, tile_q) || (tiles > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 0: return (int)launch_transpose<0>(
        knots, g, x, leg, out_y, out_m, scratch, B, L, N, M, tiles, tile_q,
        x_row_stride, leg_row_stride, step, s);
    case 1: return (int)launch_transpose<1>(
        knots, g, x, leg, out_y, out_m, scratch, B, L, N, M, tiles, tile_q,
        x_row_stride, leg_row_stride, step, s);
    case 2: return (int)launch_transpose<2>(
        knots, g, x, leg, out_y, out_m, scratch, B, L, N, M, tiles, tile_q,
        x_row_stride, leg_row_stride, step, s);
    case 3: return (int)launch_transpose<3>(
        knots, g, x, leg, out_y, out_m, scratch, B, L, N, M, tiles, tile_q,
        x_row_stride, leg_row_stride, step, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vega_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
