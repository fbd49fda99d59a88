// Secure host-side noise for DP releases — the native twin of the
// reference's C++ noise hardening (the PyDP/google differential-privacy
// library uses snapping/geometric constructions; see reference
// pipeline_dp/dp_computations.py:111-143 delegating to
// pydp.algorithms.numerical_mechanisms).
//
// Two pieces:
//  * a ChaCha20-based CSPRNG (raw 64-bit blocks -> uniform doubles),
//    seeded from OS entropy by default, explicitly for tests;
//  * the snapping Laplace mechanism (Mironov, "On significance of the
//    least significant bits for differential privacy", CCS 2012):
//        F(x) = clamp_B( round_to_Lambda( clamp_B(x) + b*S*ln(U) ) )
//    with U uniform in (0,1], S a random sign, Lambda the smallest power
//    of two >= b, and round-to-nearest (ties to even) in multiples of
//    Lambda. The rounding destroys the low-order floating-point bits
//    that leak information under a textbook Laplace implementation.
//
// Built as a plain shared library; bound from Python with ctypes
// (pipelinedp_tpu_torch/native/__init__.py). No Python.h dependency.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

namespace {

// ---------------------------------------------------------------------
// ChaCha20 block function (RFC 8439) as a counter-based random stream.
// ---------------------------------------------------------------------

inline uint32_t rotl(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)                          \
  a += b; d ^= a; d = rotl(d, 16);              \
  c += d; b ^= c; b = rotl(b, 12);              \
  a += b; d ^= a; d = rotl(d, 8);               \
  c += d; b ^= c; b = rotl(b, 7);

struct ChaCha {
  uint32_t state[16];
  uint32_t block[16];
  int used;  // words consumed from the current block

  void init(const uint8_t key[32], uint64_t stream) {
    static const char sigma[17] = "expand 32-byte k";
    std::memcpy(&state[0], sigma, 16);
    std::memcpy(&state[4], key, 32);
    state[12] = 0;  // block counter
    state[13] = 0;
    state[14] = static_cast<uint32_t>(stream);
    state[15] = static_cast<uint32_t>(stream >> 32);
    used = 16;
  }

  void refill() {
    uint32_t x[16];
    std::memcpy(x, state, sizeof(x));
    for (int i = 0; i < 10; i++) {  // 20 rounds
      QR(x[0], x[4], x[8], x[12]);
      QR(x[1], x[5], x[9], x[13]);
      QR(x[2], x[6], x[10], x[14]);
      QR(x[3], x[7], x[11], x[15]);
      QR(x[0], x[5], x[10], x[15]);
      QR(x[1], x[6], x[11], x[12]);
      QR(x[2], x[7], x[8], x[13]);
      QR(x[3], x[4], x[9], x[14]);
    }
    for (int i = 0; i < 16; i++) block[i] = x[i] + state[i];
    if (++state[12] == 0) ++state[13];
    used = 0;
  }

  uint64_t next64() {
    if (used > 14) refill();
    uint64_t lo = block[used++];
    uint64_t hi = block[used++];
    return (hi << 32) | lo;
  }

  // Uniform double in (0, 1]: 53 random mantissa bits, never 0 so ln(U)
  // is finite.
  double uniform01() {
    uint64_t r = next64() >> 11;           // 53 bits
    return (static_cast<double>(r) + 1.0) * 0x1p-53;
  }
};

ChaCha g_rng;
bool g_seeded = false;

void seed_from_os() {
  uint8_t key[32];
  FILE* f = std::fopen("/dev/urandom", "rb");
  if (f != nullptr) {
    size_t got = std::fread(key, 1, sizeof(key), f);
    std::fclose(f);
    if (got == sizeof(key)) {
      g_rng.init(key, /*stream=*/0);
      g_seeded = true;
      return;
    }
  }
  // Last resort (no /dev/urandom): time-derived key. Still ChaCha-mixed.
  uint64_t t = static_cast<uint64_t>(std::clock());
  std::memset(key, 0, sizeof(key));
  std::memcpy(key, &t, sizeof(t));
  g_rng.init(key, 0);
  g_seeded = true;
}

inline void ensure_seeded() {
  if (!g_seeded) seed_from_os();
}

// Smallest power of two >= b (b > 0), as a double.
inline double lambda_for(double b) {
  int exp;
  double frac = std::frexp(b, &exp);  // b = frac * 2^exp, frac in [0.5, 1)
  return (frac == 0.5) ? std::ldexp(1.0, exp - 1) : std::ldexp(1.0, exp);
}

// Round y to the nearest multiple of lambda, ties to even — uses the
// FPU's round-to-nearest-even on y/lambda (exact: lambda is a power of
// two, so the division only shifts the exponent).
inline double round_to(double y, double lambda) {
  return std::nearbyint(y / lambda) * lambda;
}

inline double clamp(double x, double bound) {
  if (x > bound) return bound;
  if (x < -bound) return -bound;
  return x;
}

// ---------------------------------------------------------------------
// Exact discrete Gaussian (Canonne–Kamath–Steinke, "The Discrete
// Gaussian for Differential Privacy", NeurIPS 2020) — the hardened twin
// of the reference's PyDP GaussianMechanism (reference
// pipeline_dp/dp_computations.py:127-143). Rejection sampling from the
// discrete Laplace via exact Bernoulli(exp(-gamma)) coin flips; every
// Bernoulli uses one fresh 64-bit ChaCha word, so individual coin
// probabilities are realized to 2^-64 (rational gammas) / 2^-53 (the
// one real-valued acceptance gamma) — deviations far below any (eps,
// delta) this framework can express, and crucially the *support* of
// the output is exactly the integers: no floating-point noise bits.
// ---------------------------------------------------------------------

// Bernoulli(num / (den * k)) with num <= den * k, den <= 2^40, k small:
// compare one uniform 64-bit word against the exact rational threshold
// in 128-bit arithmetic (no rounding).
inline bool bern_frac(uint64_t num, uint64_t den, uint64_t k) {
  uint64_t r = g_rng.next64();
  return (static_cast<unsigned __int128>(r) * den) * k <
         (static_cast<unsigned __int128>(num) << 64);
}

// Bernoulli(p) for real p in [0, 1] at 2^-53 resolution.
inline bool bern_p(double p) {
  uint64_t r = g_rng.next64() >> 11;
  return static_cast<double>(r) < p * 0x1p53;
}

// Bernoulli(exp(-u/t)) for 0 <= u <= t (CKS Algorithm 1): run the von
// Neumann series K=1,2,... with Bernoulli(gamma/K) coins; exp(-gamma)
// is the probability K stops odd. The cap at K=64 is unreachable in
// practice (P ~ 1/64!) and breaks toward an odd K.
inline bool bexp_rat(uint64_t u, uint64_t t) {
  uint64_t k = 1;
  while (bern_frac(u, t, k)) {
    if (++k > 64) break;
  }
  return (k & 1) == 1;
}

// Bernoulli(exp(-f)) for real f in [0, 1] — same series, real coins.
inline bool bexp_frac(double f) {
  uint64_t k = 1;
  while (bern_p(f / static_cast<double>(k))) {
    if (++k > 64) break;
  }
  return (k & 1) == 1;
}

// Bernoulli(exp(-gamma)) for real gamma >= 0: exp(-gamma) =
// exp(-1)^floor(gamma) * exp(-frac(gamma)).
inline bool bexp(double gamma) {
  while (gamma > 1.0) {
    if (!bexp_rat(1, 1)) return false;
    gamma -= 1.0;
  }
  return bexp_frac(gamma < 0.0 ? 0.0 : gamma);
}

// Discrete Laplace with integer scale t: P(Y = y) proportional to
// exp(-|y|/t) (CKS Algorithm 2). U is drawn modulo-bias-free.
inline int64_t sample_dlaplace(uint64_t t) {
  for (;;) {
    uint64_t u = 0;
    if (t > 1) {
      const uint64_t lim = UINT64_MAX - UINT64_MAX % t;
      do {
        u = g_rng.next64();
      } while (u >= lim);
      u %= t;
    }
    if (!bexp_rat(u, t)) continue;  // accept U with prob exp(-U/t)
    uint64_t v = 0;  // V ~ Geometric(1 - exp(-1))
    while (bexp_rat(1, 1)) {
      if (++v > 4096) break;  // unreachable (P ~ e^-4096)
    }
    const uint64_t x = u + t * v;
    const bool neg = (g_rng.next64() & 1) != 0;
    if (neg && x == 0) continue;  // don't double-count zero
    return neg ? -static_cast<int64_t>(x) : static_cast<int64_t>(x);
  }
}

// Discrete Gaussian N_Z(0, sigma^2) (CKS Algorithm 3): rejection from
// discrete Laplace of scale t = floor(sigma) + 1; O(1) expected
// iterations independent of sigma.
inline int64_t sample_dgauss(double sigma) {
  const uint64_t t = static_cast<uint64_t>(std::floor(sigma)) + 1;
  const double s2 = sigma * sigma;
  for (;;) {
    const int64_t y = sample_dlaplace(t);
    const double a =
        std::fabs(static_cast<double>(y)) - s2 / static_cast<double>(t);
    if (bexp(a * a / (2.0 * s2))) return y;
  }
}

}  // namespace

extern "C" {

// Deterministic seeding for tests; any 64-bit seed expands into the key.
void sn_seed(uint64_t seed) {
  uint8_t key[32];
  for (int i = 0; i < 4; i++) {
    uint64_t w = seed ^ (0x9E3779B97F4A7C15ull * (i + 1));
    // splitmix64 finalizer per word.
    w ^= w >> 30; w *= 0xBF58476D1CE4E5B9ull;
    w ^= w >> 27; w *= 0x94D049BB133111EBull;
    w ^= w >> 31;
    std::memcpy(key + 8 * i, &w, 8);
  }
  g_rng.init(key, 0);
  g_seeded = true;
}

void sn_seed_from_os() { seed_from_os(); }

// Snapping Laplace: adds noise of scale b to each value in-place-style
// (reads values[i], writes out[i]), clamping to [-bound, bound].
// Returns the snapping resolution Lambda (callers may report it).
double sn_snapping_laplace(const double* values, double* out, int64_t n,
                           double b, double bound) {
  ensure_seeded();
  const double lambda = lambda_for(b);
  for (int64_t i = 0; i < n; i++) {
    uint64_t bits = g_rng.next64();
    double sign = (bits & 1) ? 1.0 : -1.0;
    double u = g_rng.uniform01();
    double y = clamp(values[i], bound) + b * sign * std::log(u);
    out[i] = clamp(round_to(y, lambda), bound);
  }
  return lambda;
}

// Raw uniform doubles in (0, 1] — exposed for statistical tests of the
// underlying stream.
void sn_uniform(double* out, int64_t n) {
  ensure_seeded();
  for (int64_t i = 0; i < n; i++) out[i] = g_rng.uniform01();
}

// Two-sided geometric ("discrete Laplace") noise with decay
// q = exp(-1/b): integer-valued noise for count releases — the release
// has no floating-point noise bits at all. Sampled exactly as the
// difference of two iid geometrics: if G1, G2 ~ Geom(1-q) on {0,1,...}
// then P(G1 - G2 = k) = (1-q)/(1+q) * q^|k|.
void sn_discrete_laplace(const int64_t* values, int64_t* out, int64_t n,
                         double b) {
  ensure_seeded();
  const double log_q = -1.0 / b;
  for (int64_t i = 0; i < n; i++) {
    int64_t g1 = static_cast<int64_t>(
        std::floor(std::log(g_rng.uniform01()) / log_q));
    int64_t g2 = static_cast<int64_t>(
        std::floor(std::log(g_rng.uniform01()) / log_q));
    out[i] = values[i] + (g1 - g2);
  }
}

// Exact discrete Gaussian noise for integer releases (counts): the
// release is an integer — no floating-point noise bits at all. Returns
// 0 on success, -1 for out-of-range sigma (must be in (0, 2^40): the
// exact-rational Bernoulli threshold needs r * t * k < 2^128).
int32_t sn_discrete_gaussian(const int64_t* values, int64_t* out,
                             int64_t n, double sigma) {
  if (!(sigma > 0.0) || sigma >= 0x1p40) return -1;
  ensure_seeded();
  for (int64_t i = 0; i < n; i++) {
    out[i] = values[i] + sample_dgauss(sigma);
  }
  return 0;
}

// Hardened Gaussian for real-valued releases, mirroring the snapping
// Laplace's contract: snap the (clamped) value to a power-of-two
// granularity g and add g * DiscreteGaussian(sigma/g). g is sized so
// sigma/g lands in (2^39, 2^40] (the top end hit exactly when sigma is
// a power of two — sample_dgauss handles t = 2^40 + 1 without 128-bit
// overflow in bern_frac): the output's support is the g-grid
// (for |value| < 2^53 * g; beyond that the double's own ulp > g is the
// effective grid — still power-of-two), so a textbook float Gaussian's
// low-mantissa-bit leakage (Mironov-style) has no channel, while the
// g/2 <= sigma * 2^-41 rounding is far below the noise. Returns g,
// or -1.0 for invalid sigma.
double sn_secure_gaussian(const double* values, double* out, int64_t n,
                          double sigma, double bound) {
  if (!(sigma > 0.0) || !std::isfinite(sigma)) return -1.0;
  ensure_seeded();
  const double g = lambda_for(sigma) * 0x1p-40;  // sigma/g in (2^39, 2^40]
  const double sigma_i = sigma / g;
  for (int64_t i = 0; i < n; i++) {
    const double v = round_to(clamp(values[i], bound), g);
    out[i] = clamp(
        v + g * static_cast<double>(sample_dgauss(sigma_i)), bound);
  }
  return g;
}

}  // extern "C"
