// Bit-exact JVM-parity math kernels for the MLlib LogisticRegression replay.
//
// The reference's LR numbers (Main/main.py:115-130, result.txt LR block) are
// the 20th iterate of Breeze L-BFGS over MLlib's standardized multinomial
// objective, computed on one partition — i.e. a fully deterministic sequence
// of IEEE-754 double operations.  Reproducing the trajectory bit-for-bit
// needs three things a straight numpy port cannot give:
//
//  1. JDK StrictMath semantics for exp/log.  JDK 8 (the Spark 2.3 era the
//     reference ran on) evaluates Math.exp/Math.log with the classic fdlibm
//     5.3 algorithms; glibc's modern correctly-rounded implementations
//     differ from fdlibm in the last ulp for some inputs, which is enough
//     to fork a 20-iteration optimizer trajectory.  jvm_exp/jvm_log below
//     implement the published fdlibm algorithm (Sun's e_exp.c / e_log.c
//     constants and operation order).
//  2. Sequential, partition-order accumulation.  MLlib's treeAggregate on
//     one partition folds instances left-to-right; netlib-java's F2J ddot
//     is likewise a strict left-to-right loop.  numpy's pairwise/BLAS sums
//     round differently.
//  3. No FMA contraction: the JVM never fuses a*b+c, so this translation
//     unit must be compiled with -ffp-contract=off (the ctypes bridge
//     passes it).
//
// Everything here is a clean-room reimplementation from the published
// algorithm descriptions (fdlibm, Spark's LogisticAggregator semantics);
// no reference-repo code exists for any of it (the reference is a PySpark
// script — see SURVEY §2b).

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

inline uint32_t high_word(double x) {
  uint64_t u;
  std::memcpy(&u, &x, 8);
  return static_cast<uint32_t>(u >> 32);
}

inline uint32_t low_word(double x) {
  uint64_t u;
  std::memcpy(&u, &x, 8);
  return static_cast<uint32_t>(u & 0xffffffffu);
}

inline void set_high_word(double &x, uint32_t hi) {
  uint64_t u;
  std::memcpy(&u, &x, 8);
  u = (static_cast<uint64_t>(hi) << 32) | (u & 0xffffffffu);
  std::memcpy(&x, &u, 8);
}

// ---- fdlibm __ieee754_exp (JDK StrictMath.exp; JDK8 Math.exp on x86-64) --
const double kOne = 1.0;
const double kHalF[2] = {0.5, -0.5};
const double kHuge = 1.0e+300;
const double kTwom1000 = 9.33263618503218878990e-302;
const double kOThreshold = 7.09782712893383973096e+02;
const double kUThreshold = -7.45133219101941108420e+02;
const double kLn2HI[2] = {6.93147180369123816490e-01,
                          -6.93147180369123816490e-01};
const double kLn2LO[2] = {1.90821492927058770002e-10,
                          -1.90821492927058770002e-10};
const double kInvLn2 = 1.44269504088896338700e+00;
const double kP1 = 1.66666666666666019037e-01;
const double kP2 = -2.77777777770155933842e-03;
const double kP3 = 6.61375632143793436117e-05;
const double kP4 = -1.65339022054652515390e-06;
const double kP5 = 4.13813679705723846039e-08;

double fdlibm_exp(double x) {
  double y, hi = 0.0, lo = 0.0, c, t;
  int32_t k = 0, xsb;
  uint32_t hx = high_word(x);
  xsb = (hx >> 31) & 1;
  hx &= 0x7fffffff;

  if (hx >= 0x40862E42) {  // |x| >= 709.78...
    if (hx >= 0x7ff00000) {
      if (((hx & 0xfffff) | low_word(x)) != 0) return x + x;  // NaN
      return (xsb == 0) ? x : 0.0;  // exp(+inf)=inf, exp(-inf)=0
    }
    if (x > kOThreshold) return kHuge * kHuge;        // overflow
    if (x < kUThreshold) return kTwom1000 * kTwom1000;  // underflow
  }

  if (hx > 0x3fd62e42) {  // |x| > 0.5 ln2
    if (hx < 0x3FF0A2B2) {  // |x| < 1.5 ln2
      hi = x - kLn2HI[xsb];
      lo = kLn2LO[xsb];
      k = 1 - xsb - xsb;
    } else {
      k = static_cast<int32_t>(kInvLn2 * x + kHalF[xsb]);
      t = k;
      hi = x - t * kLn2HI[0];
      lo = t * kLn2LO[0];
    }
    x = hi - lo;
  } else if (hx < 0x3e300000) {  // |x| < 2^-28
    if (kHuge + x > kOne) return kOne + x;
    k = 0;
  } else {
    k = 0;
  }

  t = x * x;
  c = x - t * (kP1 + t * (kP2 + t * (kP3 + t * (kP4 + t * kP5))));
  if (k == 0) return kOne - ((x * c / (c - 2.0)) - x);
  y = kOne - ((lo - (x * c) / (2.0 - c)) - hi);
  if (k >= -1021) {
    set_high_word(y, high_word(y) + (static_cast<uint32_t>(k) << 20));
    return y;
  }
  set_high_word(y, high_word(y) + (static_cast<uint32_t>(k + 1000) << 20));
  return y * kTwom1000;
}

// ---- fdlibm __ieee754_log (JDK StrictMath.log) ---------------------------
const double kLn2Hi = 6.93147180369123816490e-01;
const double kLn2Lo = 1.90821492927058770002e-10;
const double kTwo54 = 1.80143985094819840000e+16;
const double kLg1 = 6.666666666666735130e-01;
const double kLg2 = 3.999999999940941908e-01;
const double kLg3 = 2.857142874366239149e-01;
const double kLg4 = 2.222219843214978396e-01;
const double kLg5 = 1.818357216161805012e-01;
const double kLg6 = 1.531383769920937332e-01;
const double kLg7 = 1.479819860511658591e-01;

double fdlibm_log(double x) {
  double hfsq, f, s, z, R, w, t1, t2, dk;
  int32_t k = 0, i, j;
  uint32_t hx = high_word(x), lx = low_word(x);

  if (hx < 0x00100000) {  // x < 2^-1022
    if (((hx & 0x7fffffff) | lx) == 0) return -kTwo54 / 0.0;  // log(0)=-inf
    if (hx >> 31) return (x - x) / 0.0;  // log(<0)=NaN
    k -= 54;
    x *= kTwo54;
    hx = high_word(x);
  }
  if (hx >= 0x7ff00000) return x + x;  // inf/NaN
  k += static_cast<int32_t>(hx >> 20) - 1023;
  hx &= 0x000fffff;
  i = (hx + 0x95f64) & 0x100000;
  set_high_word(x, hx | (static_cast<uint32_t>(i) ^ 0x3ff00000));
  k += i >> 20;
  f = x - 1.0;
  if ((0x000fffff & (2 + hx)) < 3) {  // -2^-20 < f < 2^-20
    if (f == 0.0) {
      if (k == 0) return 0.0;
      dk = static_cast<double>(k);
      return dk * kLn2Hi + dk * kLn2Lo;
    }
    R = f * f * (0.5 - 0.33333333333333333 * f);
    if (k == 0) return f - R;
    dk = static_cast<double>(k);
    return dk * kLn2Hi - ((R - dk * kLn2Lo) - f);
  }
  s = f / (2.0 + f);
  dk = static_cast<double>(k);
  z = s * s;
  i = hx - 0x6147a;
  w = z * z;
  j = 0x6b851 - hx;
  t1 = w * (kLg2 + w * (kLg4 + w * kLg6));
  t2 = z * (kLg1 + w * (kLg3 + w * (kLg5 + w * kLg7)));
  i |= j;
  R = t2 + t1;
  if (i > 0) {
    hfsq = 0.5 * f * f;
    if (k == 0) return f - (hfsq - s * (hfsq + R));
    return dk * kLn2Hi - ((hfsq - (s * (hfsq + R) + dk * kLn2Lo)) - f);
  }
  if (k == 0) return f - s * (f - R);
  return dk * kLn2Hi - ((s * (f - R) - dk * kLn2Lo) - f);
}

// Which transcendental family the replay uses: 0 = fdlibm (JDK StrictMath,
// and Math.exp/log on the JDK 8 era the reference ran), 1 = the platform
// libm, 2 = long-double round-trip (approximates x87 double rounding ONLY
// where long double is the 80-bit extended type, i.e. x86; elsewhere it
// is just extra precision) — kept switchable so the oracle (result.txt's
// 16-digit probability strings) can arbitrate empirically.  Unknown
// values are clamped to fdlibm, the production default.
int g_math_backend = 0;

inline double exp_impl(double x) {
  switch (g_math_backend) {
    case 0: return fdlibm_exp(x);
    case 1: return std::exp(x);
    default:
      // x87-style double rounding: 80-bit extended result rounded to
      // double (what a JIT'd x87 transcendental would produce)
      return static_cast<double>(expl(static_cast<long double>(x)));
  }
}
inline double log_impl(double x) {
  switch (g_math_backend) {
    case 0: return fdlibm_log(x);
    case 1: return std::log(x);
    default:
      return static_cast<double>(logl(static_cast<long double>(x)));
  }
}

}  // namespace

extern "C" {

void set_math_backend(int backend) {
  g_math_backend = (backend == 1 || backend == 2) ? backend : 0;
}

double jvm_exp(double x) { return exp_impl(x); }
double jvm_log(double x) { return log_impl(x); }

// netlib-java F2J dnrm2: the LAPACK scaled-ssq algorithm (NOT
// sqrt(sum of squares)) — one candidate for Breeze's norm().
double dnrm2_f2j(const double *x, int64_t n) {
  if (n < 1) return 0.0;
  if (n == 1) return std::fabs(x[0]);
  double scale = 0.0, ssq = 1.0;
  for (int64_t i = 0; i < n; ++i) {
    if (x[i] != 0.0) {
      double absxi = std::fabs(x[i]);
      if (scale < absxi) {
        double r = scale / absxi;
        ssq = 1.0 + ssq * r * r;
        scale = absxi;
      } else {
        double r = absxi / scale;
        ssq = ssq + r * r;
      }
    }
  }
  return scale * std::sqrt(ssq);
}

// Strict left-to-right dot product — netlib-java F2J ddot's summation
// order (its 5-way unrolled expression evaluates left-to-right in Java,
// so it equals the plain sequential loop bit-for-bit).  Breeze norms
// derive from this: InnerProductModule's norm(v) = sqrt(v dot v).
double ddot_seq(const double *a, const double *b, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

// MLlib LogisticAggregator (multinomial) + L2Regularization + RDDLossFunction
// in one sequential pass, semantics per Spark 2.3's
// ml.optim.aggregator.LogisticAggregator.multinomialUpdateInPlace:
//   margins from standardized actives (value / featuresStd, guarded),
//   max-margin pivot, multipliers = exp/sum - 1[label], gradient update in
//   feature-major (index*k + j) layout with intercepts at the tail,
//   loss = log(sum) - marginOfLabel (+ maxMargin when positive).
// Finalization: gradient *= 1/weightSum (BLAS.scal with a precomputed
// reciprocal), then the L2 term (0.5 * sumSq * regL2 on coefficient entries
// only, gradient += regL2 * coef) — standardization=true, so the reg sees
// the scaled coefficients directly.  Returns total (agg + reg) loss.
double lr_loss_grad(const double *coef, int64_t n, int64_t d, int64_t k,
                    int fit_intercept, const int32_t *indices,
                    const double *values, const int64_t *indptr,
                    const double *labels, const double *feat_std,
                    double reg_l2, double *grad_out) {
  if (k < 1 || k > 64) return NAN;  // margins/multipliers are stack buffers
  const int64_t sz = k * d + (fit_intercept ? k : 0);
  for (int64_t i = 0; i < sz; ++i) grad_out[i] = 0.0;

  double loss_sum = 0.0;
  double weight_sum = 0.0;
  double margins[64];
  double multipliers[64];
  const double weight = 1.0;

  for (int64_t row = 0; row < n; ++row) {
    for (int64_t j = 0; j < k; ++j) margins[j] = 0.0;
    const int64_t lo = indptr[row], hi = indptr[row + 1];
    for (int64_t p = lo; p < hi; ++p) {
      const int64_t idx = indices[p];
      const double value = values[p];
      if (feat_std[idx] != 0.0 && value != 0.0) {
        const double std_value = value / feat_std[idx];
        for (int64_t j = 0; j < k; ++j)
          margins[j] += coef[idx * k + j] * std_value;
      }
    }
    const int32_t label = static_cast<int32_t>(labels[row]);
    double margin_of_label = 0.0;
    double max_margin = -HUGE_VAL;  // Double.NegativeInfinity
    for (int64_t i = 0; i < k; ++i) {
      if (fit_intercept) margins[i] += coef[k * d + i];
      if (i == label) margin_of_label = margins[i];
      if (margins[i] > max_margin) max_margin = margins[i];
    }

    double sum = 0.0;
    for (int64_t i = 0; i < k; ++i) {
      if (max_margin > 0) margins[i] -= max_margin;
      const double e = exp_impl(margins[i]);
      sum += e;
      multipliers[i] = e;
    }
    for (int64_t i = 0; i < k; ++i)
      multipliers[i] = multipliers[i] / sum - (label == i ? 1.0 : 0.0);

    for (int64_t p = lo; p < hi; ++p) {
      const int64_t idx = indices[p];
      const double value = values[p];
      if (feat_std[idx] != 0.0 && value != 0.0) {
        const double std_value = value / feat_std[idx];
        for (int64_t j = 0; j < k; ++j)
          grad_out[idx * k + j] += weight * multipliers[j] * std_value;
      }
    }
    if (fit_intercept) {
      for (int64_t i = 0; i < k; ++i)
        grad_out[k * d + i] += weight * multipliers[i];
    }

    const double loss = (max_margin > 0)
                            ? log_impl(sum) - margin_of_label + max_margin
                            : log_impl(sum) - margin_of_label;
    loss_sum += weight * loss;
    weight_sum += weight;
  }

  // LogisticAggregator.gradient: scal(1.0 / weightSum, clone of sums)
  const double inv_w = 1.0 / weight_sum;
  for (int64_t i = 0; i < sz; ++i) grad_out[i] = grad_out[i] * inv_w;
  double total = loss_sum / weight_sum;

  if (reg_l2 != 0.0) {
    // L2Regularization.calculate, applyFeaturesStd=None: sums value² over
    // coefficient (non-intercept) entries in index order; the reg gradient
    // lands via BLAS.axpy(1.0, regGrad, grad).
    double sum_sq = 0.0;
    const int64_t n_coef = d * k;
    for (int64_t idx = 0; idx < n_coef; ++idx) {
      const double v = coef[idx];
      sum_sq += v * v;
      grad_out[idx] = grad_out[idx] + reg_l2 * v;
    }
    total = total + 0.5 * sum_sq * reg_l2;
  }
  return total;
}

// ProbabilisticClassificationModel.transform for the multinomial model:
// margins via BLAS.gemv(1.0, coefMatrix(row-major k×d), sparse x, 1.0,
// intercepts) — per-class strict sequential sum over actives, then
// y = sum*1.0 + 1.0*intercept — and raw2probabilityInPlace's max-margin
// pivoted exp with a final scal(1/sum) (multiply by the reciprocal).
void lr_predict(const double *coefm, const double *intercepts, int64_t n,
                int64_t d, int64_t k, const int32_t *indices,
                const double *values, const int64_t *indptr, double *raw_out,
                double *prob_out) {
  if (k < 1 || k > 64) return;
  for (int64_t row = 0; row < n; ++row) {
    const int64_t lo = indptr[row], hi = indptr[row + 1];
    double *raw = raw_out + row * k;
    double *prob = prob_out + row * k;
    for (int64_t c = 0; c < k; ++c) {
      double sum = 0.0;
      for (int64_t p = lo; p < hi; ++p)
        sum += values[p] * coefm[c * d + indices[p]];
      raw[c] = sum * 1.0 + 1.0 * intercepts[c];
    }
    // raw2probabilityInPlace: pivot by the (first) max margin when > 0
    int64_t max_idx = 0;
    for (int64_t c = 1; c < k; ++c)
      if (raw[c] > raw[max_idx]) max_idx = c;
    const double max_margin = raw[max_idx];
    double sum = 0.0;
    for (int64_t c = 0; c < k; ++c) {
      prob[c] = (max_margin > 0) ? exp_impl(raw[c] - max_margin)
                                 : exp_impl(raw[c]);
      sum += prob[c];
    }
    const double inv = 1.0 / sum;
    for (int64_t c = 0; c < k; ++c) prob[c] = prob[c] * inv;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RandomForest bagging RNG stack (clean-room ports of published algorithms)
// ---------------------------------------------------------------------------
// MLlib's RF (reference Main/main.py:478) draws its randomness from three
// generators, all replayed here:
//   - commons-math3 Well19937c + PoissonDistribution(1.0).sample() for the
//     per-(row, tree) bootstrap counts (BaggedPoint, seed+partition+1);
//   - Spark's XORShiftRandom for per-node feature-subset reservoir
//     sampling (SamplingUtils.reservoirSampleAndCount) — the caller
//     passes the MurmurHash3-mixed initial state (the 64-byte-buffer
//     seed quirk lives in har_tpu.data.spark_random);
//   - java.util.Random's LCG for the per-node seed stream (Python side).

namespace {

constexpr int kWellR = 624;  // (19937 + 31) / 32

struct Well19937c {
  int32_t v[kWellR];
  int index;

  void seed_long(int64_t seed) {
    // AbstractWell.setSeed(long) -> setSeed(int[]{hi, lo}), then fill
    // v[i] = (int)((1812433253L * (v[i-2] ^ (v[i-2] >> 30)) + i))
    int32_t init[2] = {
        static_cast<int32_t>(static_cast<uint64_t>(seed) >> 32),
        static_cast<int32_t>(seed & 0xffffffffLL)};
    v[0] = init[0];
    v[1] = init[1];
    for (int i = 2; i < kWellR; ++i) {
      int64_t l = v[i - 2];  // sign-extended, like Java's int -> long
      v[i] = static_cast<int32_t>(
          (1812433253LL * (l ^ (l >> 30)) + i) & 0xffffffffLL);
    }
    index = 0;
  }

  int32_t next(int bits) {
    const int index_rm1 = (index + kWellR - 1) % kWellR;
    const int index_rm2 = (index + kWellR - 2) % kWellR;
    const int32_t v0 = v[index];
    const int32_t vm1 = v[(index + 70) % kWellR];
    const int32_t vm2 = v[(index + 179) % kWellR];
    const int32_t vm3 = v[(index + 449) % kWellR];

    const int32_t z0 = (0x80000000 & v[index_rm1]) ^ (0x7fffffff & v[index_rm2]);
    const int32_t z1 = (v0 ^ (v0 << 25)) ^
                       (vm1 ^ static_cast<int32_t>(static_cast<uint32_t>(vm1) >> 27));
    const int32_t z2 = static_cast<int32_t>(static_cast<uint32_t>(vm2) >> 9) ^
                       (vm3 ^ static_cast<int32_t>(static_cast<uint32_t>(vm3) >> 1));
    const int32_t z3 = z1 ^ z2;
    const int32_t z4 = z0 ^ (z1 ^ (z1 << 9)) ^ (z2 ^ (z2 << 21)) ^
                       (z3 ^ static_cast<int32_t>(static_cast<uint32_t>(z3) >> 21));

    v[index] = z3;
    v[index_rm1] = z4;
    v[index_rm2] &= 0x80000000;
    index = index_rm1;

    // Matsumoto-Kurita tempering (the "c" in Well19937c)
    int32_t z4t = z4 ^ ((z4 << 7) & static_cast<int32_t>(0xe46e1700));
    z4t = z4t ^ ((z4t << 15) & static_cast<int32_t>(0x9b868000));
    return static_cast<int32_t>(static_cast<uint32_t>(z4t) >> (32 - bits));
  }

  double next_double() {
    // BitsStreamGenerator.nextDouble: (next(26)<<26 | next(26)&0x3ffffff)
    // * 2^-52
    const int64_t high = static_cast<int64_t>(next(26)) << 26;
    const int32_t low = next(26) & 0x03ffffff;
    return static_cast<double>(high | low) * 0x1.0p-52;
  }

  // commons-math3 PoissonDistribution.sample() for mean < 40: Knuth's
  // multiplication method.
  int64_t next_poisson(double mean, double p) {
    int64_t n = 0;
    double r = 1.0;
    while (n < 1000 * mean) {
      const double rnd = next_double();
      r *= rnd;
      if (r >= p) {
        n++;
      } else {
        return n;
      }
    }
    return n;
  }
};

struct XorShift64 {
  uint64_t state;  // MurmurHash3-mixed, supplied by the caller

  int32_t next(int bits) {
    uint64_t s = state;
    s ^= s << 21;
    s ^= s >> 35;
    s ^= s << 4;
    state = s;
    return static_cast<int32_t>(s & ((1LL << bits) - 1));
  }

  double next_double() {
    // java.util.Random.nextDouble over the overridden next()
    const int64_t high = static_cast<int64_t>(next(26)) << 27;
    return static_cast<double>(high + next(27)) * 0x1.0p-53;
  }
};

}  // namespace

extern "C" {

// (n_rows, num_trees) Poisson(subsample) bootstrap counts, row-major,
// exactly the BaggedPoint stream: one Well19937c seeded once with
// (seed + partitionIndex + 1), rows outer, trees inner.
//
// Bit-exactness contract: parity is verified ONLY for subsample=1.0 (the
// value MLlib's RandomForestClassifier always uses and the only one the
// reference run exercises).  commons-math3 computes the rejection
// threshold with FastMath.exp, which can differ from fdlibm_exp in the
// last ulp for other arguments; exp(-1.0) is test-verified identical.
// Port FastMath's table-driven exp before trusting non-unit subsample.
void rf_poisson_weights(int64_t seed, int64_t n_rows, int64_t num_trees,
                        double subsample, double *out) {
  Well19937c rng;
  rng.seed_long(seed);
  const double p = fdlibm_exp(-subsample);  // FastMath.exp(-mean); see contract above
  for (int64_t r = 0; r < n_rows; ++r)
    for (int64_t t = 0; t < num_trees; ++t)
      out[r * num_trees + t] = static_cast<double>(rng.next_poisson(subsample, p));
}

// SamplingUtils.reservoirSampleAndCount over Range(0, n_items) with k
// slots; xorshift_state is the MurmurHash3-mixed XORShiftRandom seed.
void reservoir_sample_range(uint64_t xorshift_state, int64_t n_items,
                            int64_t k, int32_t *out) {
  for (int64_t i = 0; i < k && i < n_items; ++i) out[i] = static_cast<int32_t>(i);
  if (n_items <= k) return;
  XorShift64 rng{xorshift_state};
  int64_t l = k;
  for (int64_t item = k; item < n_items; ++item) {
    l += 1;
    const int64_t replacement =
        static_cast<int64_t>(rng.next_double() * static_cast<double>(l));
    if (replacement < k) out[replacement] = static_cast<int32_t>(item);
  }
}

}  // extern "C"
