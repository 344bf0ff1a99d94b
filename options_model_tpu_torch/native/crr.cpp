// Native CRR binomial pricer: the host oracle of options_model_tpu/native/
// crr.cpp, copied so that the port builds it without the JAX package.
//
// The binomial tree is a strictly sequential triangular recursion, so the
// oracle runs on the host; it is not a device kernel. pricers/binomial.py
// builds it at first use (g++ -O3 -shared -fPIC into build/native/) and
// binds it with ctypes (crr_price(..., use_native=True)); the NumPy tree
// there is its plain version.

#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

extern "C" {

// cp: +1 call / -1 put. american: 1 = early exercise allowed.
// q_div: continuous dividend yield (risk-neutral growth r - q_div; the
// discount rate stays r).
double crr_price_q(double S0, double K, double T, double r, double q_div,
                   double sigma, int cp, int n_steps, int american) {
  const double dt = T / n_steps;
  const double u = std::exp(sigma * std::sqrt(dt));
  const double d = 1.0 / u;
  const double disc = std::exp(-r * dt);
  const double p = (std::exp((r - q_div) * dt) - d) / (u - d);
  // Mirror the NumPy tree's validation: outside (0,1) the tree's
  // risk-neutral measure is invalid — return NaN so the Python wrapper
  // raises instead of silently pricing with negative probabilities.
  if (!(p > 0.0 && p < 1.0)) return std::numeric_limits<double>::quiet_NaN();
  const double q = 1.0 - p;

  std::vector<double> value(n_steps + 1);
  // Terminal layer: S = S0 * u^(2j - n)
  for (int j = 0; j <= n_steps; ++j) {
    const double S_T = S0 * std::exp(sigma * std::sqrt(dt) * (2.0 * j - n_steps));
    value[j] = std::max(cp * (S_T - K), 0.0);
  }

  for (int step = n_steps - 1; step >= 0; --step) {
    for (int j = 0; j <= step; ++j) {
      double cont = disc * (p * value[j + 1] + q * value[j]);
      if (american) {
        const double S_t = S0 * std::exp(sigma * std::sqrt(dt) * (2.0 * j - step));
        const double ex = cp * (S_t - K);
        cont = std::max(cont, ex);
      }
      value[j] = cont;
    }
  }
  return value[0];
}

}  // extern "C"
