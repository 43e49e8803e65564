// Pair-histogram kernels for the new-metals distortion matrices.
//
// The reference builds these matrices in numpy by materializing all
// O(n1*n2) pair products (reference: metals.py:502-654) — multi-GB
// temporaries and minutes of wall clock for survey-sized stacked-delta
// files. These kernels stream the pairs in OpenMP-parallel tiles; no
// pair array is ever materialized.
//
// Derived from vega_tpu/native/pair_hist.cpp, with one departure: the
// sums are reproducible. vega_tpu's copy gives each thread the rows a
// dynamic schedule hands it and adds the per-thread partials, so its
// sums change from run to run and with the thread count. Here the rows
// i are split into a fixed number of contiguous partitions
// (kPartitions, whatever the thread count), each partition sums its rows
// in order into its own partial, and the partials are added in partition
// order: the same bits at any OMP_NUM_THREADS.
//
// Built at first use with g++ -O3 -march=native -fopenmp -shared -fPIC
// into build/vega_tpu_torch/ and loaded with ctypes (see pair_hist.py).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <memory>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t find_bin(double x, double lo, double hi, int64_t n) {
    // np.histogram semantics: uniform bins, right-inclusive last edge
    if (x < lo || x > hi) return -1;
    if (x == hi) return n - 1;
    int64_t b = static_cast<int64_t>((x - lo) / (hi - lo) * n);
    if (b < 0) return -1;
    if (b >= n) return n - 1;
    return b;
}

// The rows of tracer 1 are summed in this many contiguous partitions
// (fewer when there are fewer rows), whatever the thread count.
constexpr int64_t kPartitions = 64;
// The partials are added into the outputs in blocks of this many entries,
// one block per thread at a time.
constexpr int64_t kReduceBlock = 512;

}  // namespace

extern "C" {

// Accumulate every pair (i, j) of tracer samples into:
//   h2[a, t]        : 2D histogram of (assumed_rp, true_rp) with weight w_ij
//   sum_true[t]     : per-true-rp-bin weight sums
//   sum_assumed[a]  : per-assumed-rp-bin weight sums
//   sum_assumed_rp[a]: weighted assumed_rp sums
//   sum_z[a]        : weighted mean-true-z sums
//   ratio_hist[q]   : histogram of assumed_dist/true_dist with weights
//                     w / true_dist^2 * (|true_rp| < rp_ratio_cut)
//
// w_ij = w1[i] * w2[j] * [zmin <= (az1[i]+az2[j])/2 <= zmax]
// rp   = r1[i] - r2[j]  (absolute value if abs_rp != 0)
//
// All output buffers must be zero-initialized by the caller. The sums
// are the same bits at any thread count (the partitions above).
void pair_histograms(
    // tracer 1
    const double* true_r1, const double* assumed_r1,
    const double* true_z1, const double* assumed_z1,
    const double* w1, int64_t n1,
    // tracer 2
    const double* true_r2, const double* assumed_r2,
    const double* true_z2, const double* assumed_z2,
    const double* w2, int64_t n2,
    // config
    int abs_rp, double zmin, double zmax,
    double rp_min, double rp_max, int64_t n_rp,
    double ratio_min, double ratio_max, int64_t n_ratio,
    double rp_ratio_cut,
    // outputs
    double* h2, double* sum_true, double* sum_assumed,
    double* sum_assumed_rp, double* sum_z, double* ratio_hist) {

    const int64_t n2d = n_rp * n_rp;
    const int64_t n_parts = n1 < kPartitions ? n1 : kPartitions;

    // one partition's partials, contiguous: h2, sum_true, sum_assumed,
    // sum_assumed_rp, sum_z, ratio_hist; zeroed by the thread that fills
    // them, not here
    const int64_t width = n2d + 4 * n_rp + n_ratio;
    std::unique_ptr<double[]> partials(new double[n_parts * width]);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int64_t p = 0; p < n_parts; ++p) {
        double* h2_t = partials.get() + p * width;
        std::fill(h2_t, h2_t + width, 0.0);
        double* st_t = h2_t + n2d;
        double* sa_t = st_t + n_rp;
        double* sar_t = sa_t + n_rp;
        double* sz_t = sar_t + n_rp;
        double* rh_t = sz_t + n_rp;
        const int64_t i_begin = p * n1 / n_parts;
        const int64_t i_end = (p + 1) * n1 / n_parts;

        for (int64_t i = i_begin; i < i_end; ++i) {
            const double tr1 = true_r1[i], ar1 = assumed_r1[i];
            const double tz1 = true_z1[i], az1 = assumed_z1[i];
            const double wi = w1[i];
            if (wi == 0.0) continue;

            for (int64_t j = 0; j < n2; ++j) {
                const double zpair = 0.5 * (az1 + assumed_z2[j]);
                if (zpair < zmin || zpair > zmax) continue;
                const double w = wi * w2[j];
                if (w == 0.0) continue;

                double true_rp = tr1 - true_r2[j];
                double assumed_rp = ar1 - assumed_r2[j];
                if (abs_rp) {
                    true_rp = std::fabs(true_rp);
                    assumed_rp = std::fabs(assumed_rp);
                }

                const int64_t bt = find_bin(true_rp, rp_min, rp_max, n_rp);
                const int64_t ba = find_bin(assumed_rp, rp_min, rp_max,
                                            n_rp);

                if (ba >= 0 && bt >= 0) h2_t[ba * n_rp + bt] += w;
                if (bt >= 0) st_t[bt] += w;
                if (ba >= 0) {
                    sa_t[ba] += w;
                    sar_t[ba] += w * assumed_rp;
                    sz_t[ba] += w * 0.5 * (tz1 + true_z2[j]);
                }

                if (std::fabs(true_rp) < rp_ratio_cut && n_ratio > 0) {
                    const double true_md = 0.5 * (tr1 + true_r2[j]);
                    const double assumed_md = 0.5 * (ar1 + assumed_r2[j]);
                    if (true_md != 0.0) {
                        const double ratio = assumed_md / true_md;
                        const int64_t br = find_bin(ratio, ratio_min,
                                                    ratio_max, n_ratio);
                        if (br >= 0)
                            rh_t[br] += w / (true_md * true_md);
                    }
                }
            }
        }
    }

    // each entry: the outputs' value, then the partitions' partials added
    // in partition order, never thread order (entries in parallel)
    double* outputs[6] = {h2, sum_true, sum_assumed, sum_assumed_rp, sum_z,
                          ratio_hist};
    const int64_t sizes[6] = {n2d, n_rp, n_rp, n_rp, n_rp, n_ratio};
    std::vector<double> total(width);
    for (int64_t o = 0, k = 0; o < 6; k += sizes[o++])
        std::copy(outputs[o], outputs[o] + sizes[o], total.data() + k);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t k0 = 0; k0 < width; k0 += kReduceBlock) {
        const int64_t k1 = k0 + kReduceBlock < width ? k0 + kReduceBlock
                                                     : width;
        for (int64_t p = 0; p < n_parts; ++p) {
            const double* part = partials.get() + p * width;
            for (int64_t k = k0; k < k1; ++k) total[k] += part[k];
        }
    }
    for (int64_t o = 0, k = 0; o < 6; k += sizes[o++])
        std::copy(total.data() + k, total.data() + k + sizes[o], outputs[o]);
}

// min/max of the distance ratios over ALL pairs — np.histogram with no
// explicit range spans the full data (zero-weight pairs included), so
// exact parity requires the unconditioned extremes.
void pair_ratio_range(
    const double* true_r1, const double* assumed_r1, int64_t n1,
    const double* true_r2, const double* assumed_r2, int64_t n2,
    double* out_min, double* out_max) {

    double rmin = 1e300, rmax = -1e300;

#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(min : rmin) reduction(max : rmax)
#endif
    for (int64_t i = 0; i < n1; ++i) {
        const double tr1 = true_r1[i], ar1 = assumed_r1[i];
        for (int64_t j = 0; j < n2; ++j) {
            const double true_md = 0.5 * (tr1 + true_r2[j]);
            if (true_md == 0.0) continue;
            const double ratio = 0.5 * (ar1 + assumed_r2[j]) / true_md;
            if (ratio < rmin) rmin = ratio;
            if (ratio > rmax) rmax = ratio;
        }
    }
    *out_min = rmin;
    *out_max = rmax;
}

}  // extern "C"
