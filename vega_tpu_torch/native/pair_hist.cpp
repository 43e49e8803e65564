// Pair-histogram kernels for the new-metals distortion matrices.
//
// The reference builds these matrices in numpy by materializing all
// O(n1*n2) pair products (reference: metals.py:502-654) — multi-GB
// temporaries and minutes of wall clock for survey-sized stacked-delta
// files. These kernels stream the pairs in OpenMP-parallel tiles with
// per-thread accumulators; no pair array is ever materialized.
//
// A copy of vega_tpu/native/pair_hist.cpp. Built at first use with
// g++ -O3 -march=native -fopenmp -shared -fPIC into build/vega_tpu_torch/
// and loaded with ctypes (see pair_hist.py).

#include <cmath>
#include <cstdint>
#include <cstring>
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
// All output buffers must be zero-initialized by the caller.
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

#ifdef _OPENMP
    const int max_threads = omp_get_max_threads();
#else
    const int max_threads = 1;
#endif

    std::vector<std::vector<double>> h2_loc(max_threads),
        st_loc(max_threads), sa_loc(max_threads), sar_loc(max_threads),
        sz_loc(max_threads), rh_loc(max_threads);
    for (int t = 0; t < max_threads; ++t) {
        h2_loc[t].assign(n2d, 0.0);
        st_loc[t].assign(n_rp, 0.0);
        sa_loc[t].assign(n_rp, 0.0);
        sar_loc[t].assign(n_rp, 0.0);
        sz_loc[t].assign(n_rp, 0.0);
        rh_loc[t].assign(n_ratio, 0.0);
    }

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t i = 0; i < n1; ++i) {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
#else
        const int tid = 0;
#endif
        double* h2_t = h2_loc[tid].data();
        double* st_t = st_loc[tid].data();
        double* sa_t = sa_loc[tid].data();
        double* sar_t = sar_loc[tid].data();
        double* sz_t = sz_loc[tid].data();
        double* rh_t = rh_loc[tid].data();

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
            const int64_t ba = find_bin(assumed_rp, rp_min, rp_max, n_rp);

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
                    const int64_t br = find_bin(ratio, ratio_min, ratio_max,
                                                n_ratio);
                    if (br >= 0)
                        rh_t[br] += w / (true_md * true_md);
                }
            }
        }
    }

    for (int t = 0; t < max_threads; ++t) {
        for (int64_t k = 0; k < n2d; ++k) h2[k] += h2_loc[t][k];
        for (int64_t k = 0; k < n_rp; ++k) {
            sum_true[k] += st_loc[t][k];
            sum_assumed[k] += sa_loc[t][k];
            sum_assumed_rp[k] += sar_loc[t][k];
            sum_z[k] += sz_loc[t][k];
        }
        for (int64_t k = 0; k < n_ratio; ++k)
            ratio_hist[k] += rh_loc[t][k];
    }
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
