// Native host-side preprocessing for linearcorex_tpu.
//
// Role (SURVEY.md §2.2 / §2.1): the reference's preprocessing layer leans on
// scipy (rankdata + norm.ppf) on the host. For large n x p panels that path
// is the data-loading bottleneck before anything reaches the TPU, so this
// library provides a native implementation of the two host-side kernels:
//
//   - empirical_gaussianize: per-column average-tie ranking followed by the
//     inverse normal CDF, out[i,j] = Phi^-1((rank_ij - 0.5)/n)
//   - mean_impute: sentinel-value imputation by per-column observed means
//
// The inverse normal CDF is Wichura's algorithm AS241 (PPND16), accurate to
// ~1e-16 — the same algorithm scipy's ndtri family uses, so the Python
// fallback and this library agree to double precision.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// Wichura (1988), Applied Statistics 37(3), algorithm AS241 PPND16.
double ppnd16(double p) {
  const double q = p - 0.5;
  double r;
  if (std::fabs(q) <= 0.425) {
    r = 0.180625 - q * q;
    return q *
           (((((((2.5090809287301226727e3 * r + 3.3430575583588128105e4) * r +
                 6.7265770927008700853e4) * r + 4.5921953931549871457e4) * r +
               1.3731693765509461125e4) * r + 1.9715909503065514427e3) * r +
             1.3314166789178437745e2) * r + 3.3871328727963666080e0) /
           (((((((5.2264952788528545610e3 * r + 2.8729085735721942674e4) * r +
                 3.9307895800092710610e4) * r + 2.1213794301586595867e4) * r +
               5.3941960214247511077e3) * r + 6.8718700749205790830e2) * r +
             4.2313330701600911252e1) * r + 1.0);
  }
  r = (q < 0.0) ? p : 1.0 - p;
  if (r <= 0.0) return (q < 0.0) ? -INFINITY : INFINITY;
  r = std::sqrt(-std::log(r));
  double val;
  if (r <= 5.0) {
    r -= 1.6;
    val = (((((((7.74545014278341407640e-4 * r + 2.27238449892691845833e-2) *
                    r + 2.41780725177450611770e-1) * r +
               1.27045825245236838258e0) * r + 3.64784832476320460504e0) * r +
             5.76949722146069140550e0) * r + 4.63033784615654529590e0) * r +
           1.42343711074968357734e0) /
          (((((((1.05075007164441684324e-9 * r + 5.47593808499534494600e-4) *
                    r + 1.51986665636164571966e-2) * r +
               1.48103976427480074590e-1) * r + 6.89767334985100004550e-1) *
             r + 1.67638483018380384940e0) * r + 2.05319162663775882187e0) *
               r + 1.0);
  } else {
    r -= 5.0;
    val = (((((((2.01033439929228813265e-7 * r + 2.71155556874348757815e-5) *
                    r + 1.24266094738807843860e-3) * r +
               2.65321895265761230930e-2) * r + 2.96560571828504891230e-1) *
             r + 1.78482653991729133580e0) * r + 5.46378491116411436990e0) *
               r + 6.65790464350110377720e0) /
          (((((((2.04426310338993978564e-15 * r + 1.42151175831644588870e-7) *
                    r + 1.84631831751005468180e-5) * r +
               7.86869131145613259100e-4) * r + 1.48753612908506148525e-2) *
             r + 1.36929880922735805310e-1) * r + 5.99832206555887937690e-1) *
               r + 1.0);
  }
  return (q < 0.0) ? -val : val;
}

}  // namespace

extern "C" {

// x, out: column-major-agnostic — row-major (n, p), stride p.
void lcx_empirical_gaussianize(const double* x, double* out, int64_t n,
                               int64_t p) {
  std::vector<int64_t> idx(n);
  std::vector<double> rank(n);
  for (int64_t j = 0; j < p; ++j) {
    std::iota(idx.begin(), idx.end(), int64_t{0});
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      return x[a * p + j] < x[b * p + j];
    });
    // average ranks over tied runs
    int64_t i = 0;
    while (i < n) {
      int64_t e = i + 1;
      const double v = x[idx[i] * p + j];
      while (e < n && x[idx[e] * p + j] == v) ++e;
      const double avg = 0.5 * static_cast<double>(i + e - 1) + 1.0;
      for (int64_t t = i; t < e; ++t) rank[idx[t]] = avg;
      i = e;
    }
    const double inv_n = 1.0 / static_cast<double>(n);
    for (int64_t r = 0; r < n; ++r)
      out[r * p + j] = ppnd16((rank[r] - 0.5) * inv_n);
  }
}

// Replace entries equal to `sentinel` by the per-column mean of the rest.
void lcx_mean_impute(double* x, int64_t n, int64_t p, double sentinel) {
  for (int64_t j = 0; j < p; ++j) {
    double sum = 0.0;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
      const double v = x[i * p + j];
      if (v != sentinel) {
        sum += v;
        ++cnt;
      }
    }
    const double mean = cnt > 0 ? sum / static_cast<double>(cnt) : 0.0;
    for (int64_t i = 0; i < n; ++i) {
      if (x[i * p + j] == sentinel) x[i * p + j] = mean;
    }
  }
}

// NaN-sentinel variant (NaN != NaN, so the equality loop can't see it).
void lcx_mean_impute_nan(double* x, int64_t n, int64_t p) {
  for (int64_t j = 0; j < p; ++j) {
    double sum = 0.0;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
      const double v = x[i * p + j];
      if (!std::isnan(v)) {
        sum += v;
        ++cnt;
      }
    }
    const double mean = cnt > 0 ? sum / static_cast<double>(cnt) : 0.0;
    for (int64_t i = 0; i < n; ++i) {
      if (std::isnan(x[i * p + j])) x[i * p + j] = mean;
    }
  }
}

// Inverse normal CDF, vectorized (for tests / reuse).
void lcx_ndtri(const double* p_in, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = ppnd16(p_in[i]);
}

}  // extern "C"
