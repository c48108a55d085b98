// Native implementation of the multirand-compatible RNG engines.
//
// Bit-exact C++ port of pic1dp_tpu_torch/rng/multirand.py (itself a port of the
// reference's src/multirand.F90): KISS64 (:921-945), MT19937-64 (:952-997),
// SuperKISS64 (:1004-1039), the constant/clock/urandom seeding schemes
// (:244-351), warm-up (:373-381), uniform [0,1] conversion (:49) and the
// Marsaglia polar Gaussian with carry buffer (:784-914).  The Python module
// is the correctness oracle (tests/test_multirand.py compares the two); this
// is the fast path for multi-million-marker deterministic loading.
//
// C ABI (used via ctypes from pic1dp_tpu_torch/rng/native/__init__.py):
//   void*  mr_create(int algorithm, int seed_type, long mype, int warmup)
//          (mype < 0 means "no rank mixing")
//   void   mr_destroy(void*)
//   unsigned long long mr_int64(void*)
//   void   mr_real_array(void*, double* out, long n)
//   void   mr_gaussian_array(void*, double* out, long n)

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int NN_SK = 20632;           // SuperKISS state words
constexpr int NSEEDS_TOTAL = 20635;
constexpr double MAX_I64 = 9223372036854775807.0;
constexpr double MAX_U64 = 18446744073709551615.0;

const uint64_t PRIMES1[100] = {
    15484219, 15484223, 15484243, 15484247, 15484279,
    15484333, 15484363, 15484387, 15484393, 15484409,
    15484421, 15484453, 15484457, 15484459, 15484471,
    15484489, 15484517, 15484519, 15484549, 15484559,
    15484591, 15484627, 15484631, 15484643, 15484661,
    15484697, 15484709, 15484723, 15484769, 15484771,
    15484783, 15484817, 15484823, 15484873, 15484877,
    15484879, 15484901, 15484919, 15484939, 15484951,
    15484961, 15484999, 15485039, 15485053, 15485059,
    15485077, 15485083, 15485143, 15485161, 15485179,
    15485191, 15485221, 15485243, 15485251, 15485257,
    15485273, 15485287, 15485291, 15485293, 15485299,
    15485311, 15485321, 15485339, 15485341, 15485357,
    15485363, 15485383, 15485389, 15485401, 15485411,
    15485429, 15485441, 15485447, 15485471, 15485473,
    15485497, 15485537, 15485539, 15485543, 15485549,
    15485557, 15485567, 15485581, 15485609, 15485611,
    15485621, 15485651, 15485653, 15485669, 15485677,
    15485689, 15485711, 15485737, 15485747, 15485761,
    15485773, 15485783, 15485801, 15485807, 15485837,
};
const uint64_t PRIMES2[100] = {
    7001, 7013, 7019, 7027, 7039, 7043, 7057, 7069, 7079, 7103,
    7109, 7121, 7127, 7129, 7151, 7159, 7177, 7187, 7193, 7207,
    7211, 7213, 7219, 7229, 7237, 7243, 7247, 7253, 7283, 7297,
    7307, 7309, 7321, 7331, 7333, 7349, 7351, 7369, 7393, 7411,
    7417, 7433, 7451, 7457, 7459, 7477, 7481, 7487, 7489, 7499,
    7507, 7517, 7523, 7529, 7537, 7541, 7547, 7549, 7559, 7561,
    7573, 7577, 7583, 7589, 7591, 7603, 7607, 7621, 7639, 7643,
    7649, 7669, 7673, 7681, 7687, 7691, 7699, 7703, 7717, 7723,
    7727, 7741, 7753, 7757, 7759, 7789, 7793, 7817, 7823, 7829,
    7841, 7853, 7867, 7873, 7877, 7879, 7883, 7901, 7907, 7919,
};

inline uint64_t uabs64(uint64_t u) {
  int64_t v = (int64_t)u;
  return v < 0 ? ~(uint64_t)v + 1u : (uint64_t)v;
}

struct MR {
  int algorithm;   // 1 KISS64, 2 MT19937-64, 3 SuperKISS64
  int nseed;
  uint64_t seeds[NSEEDS_TOTAL];
  int iseed;
  bool has_gauss;
  double gauss_buf;
};

uint64_t kiss64_raw(uint64_t s[4]) {
  uint64_t x = s[0], y = s[1], z = s[2], c = s[3];
  uint64_t t = (x << 58) + c;
  uint64_t c_new;
  if ((x >> 63) == (t >> 63))
    c_new = (x >> 6) + (x >> 63);
  else
    c_new = (x >> 6) - ((x + t) >> 63) + 1;
  x = x + t;
  y ^= y << 13;
  y ^= y >> 17;
  y ^= y << 43;
  z = 6906969069ull * z + 1234567ull;
  s[0] = x; s[1] = y; s[2] = z; s[3] = c_new;
  return x + y + z;
}

uint64_t mt19937_64(MR* m) {
  constexpr int NN = 312, MM = 156;
  constexpr uint64_t UM = 0xFFFFFFFF80000000ull;
  constexpr uint64_t LM = 0x000000007FFFFFFFull;
  static const uint64_t MAG[2] = {0ull, 0xB5026F5AA96619E9ull};
  uint64_t* s = m->seeds;
  if (m->iseed >= NN) {
    for (int i = 0; i < NN - MM; ++i) {
      uint64_t x = (s[i] & UM) | (s[i + 1] & LM);
      s[i] = s[i + MM] ^ (x >> 1) ^ MAG[x & 1];
    }
    for (int i = NN - MM; i < NN - 1; ++i) {
      uint64_t x = (s[i] & UM) | (s[i + 1] & LM);
      s[i] = s[i + MM - NN] ^ (x >> 1) ^ MAG[x & 1];
    }
    uint64_t x = (s[NN - 1] & UM) | (s[0] & LM);
    s[NN - 1] = s[MM - 1] ^ (x >> 1) ^ MAG[x & 1];
    m->iseed = 0;
  }
  uint64_t x = s[m->iseed++];
  x ^= (x >> 29) & 0x5555555555555555ull;
  x ^= (x << 17) & 0x71D67FFFEDA60000ull;
  x ^= (x << 37) & 0xFFF7EEE000000000ull;
  x ^= x >> 43;
  return x;
}

uint64_t superkiss64(MR* m) {
  constexpr int ICARRY = NN_SK, IXCNG = NN_SK + 1, IXS = NN_SK + 2;
  uint64_t* s = m->seeds;
  if (m->iseed >= NN_SK) {
    uint64_t carry = s[ICARRY];
    for (int i = 0; i < NN_SK; ++i) {
      uint64_t q = s[i];
      uint64_t h = carry & 1;
      uint64_t z = ((q << 41) >> 1) + ((q << 39) >> 1) + (carry >> 1);
      carry = (q >> 23) + (q >> 25) + (z >> 63);
      s[i] = ~((z << 1) + h);
    }
    s[ICARRY] = carry;
    m->iseed = 0;
  }
  s[IXCNG] = s[IXCNG] * 6906969069ull + 123ull;
  uint64_t y = s[IXS];
  y ^= y << 13;
  y ^= y >> 17;
  y ^= y << 43;
  s[IXS] = y;
  return s[m->iseed++] + s[IXCNG] + y;
}

uint64_t draw64(MR* m) {
  switch (m->algorithm) {
    case 2: return mt19937_64(m);
    case 3: return superkiss64(m);
    default: return kiss64_raw(m->seeds);
  }
}

void set_start_index(MR* m) {
  if (m->algorithm == 2) m->iseed = 312;
  else if (m->algorithm == 3) m->iseed = NN_SK;
  else m->iseed = 0;
}

bool urandom_fill(uint64_t* dst, int n) {
  FILE* f = std::fopen("/dev/urandom", "rb");
  if (!f) return false;
  size_t got = std::fread(dst, sizeof(uint64_t), n, f);
  std::fclose(f);
  return got == (size_t)n;
}

void init_seeds(MR* m, int seed_type, long mype) {
  int nseed = m->nseed;
  if (seed_type == 3) {
    if (urandom_fill(m->seeds, nseed)) {
      if (m->algorithm == 1) {
        while (m->seeds[1] == 0) urandom_fill(&m->seeds[1], 1);
        while (m->seeds[0] == 0 && m->seeds[3] == 0) {
          urandom_fill(&m->seeds[0], 1);
          urandom_fill(&m->seeds[3], 1);
        }
      } else if (m->algorithm == 3) {
        while (m->seeds[20634] == 0) urandom_fill(&m->seeds[20634], 1);
      }
      set_start_index(m);
      return;
    }
    seed_type = 2;  // urandom unavailable: fall back to clock seeding
  }
  uint64_t clock;
  if (seed_type == 2)
    clock = (uint64_t)std::chrono::steady_clock::now().time_since_epoch().count();
  else
    clock = PRIMES1[1];
  uint64_t base[4] = {clock, clock, clock, clock};
  if (mype >= 0) {
    uint64_t idx = (uabs64(clock + PRIMES2[uabs64(clock) % 100] * (uint64_t)mype)) % 100;
    for (int i = 0; i < 4; ++i) base[i] += PRIMES1[idx] * (uint64_t)mype;
  }
  for (int i = 0; i < 4; ++i) {
    uint64_t idx = uabs64(base[i] + PRIMES1[uabs64(clock) % 100] * (uint64_t)i) % 100;
    base[i] += PRIMES2[idx] * (uint64_t)i;
  }
  uint64_t kiss_state[4] = {base[0], base[1], base[2], base[3]};
  uint64_t tmp[NSEEDS_TOTAL] = {0};
  for (int i = 0; i < 20; ++i) tmp[0] = kiss64_raw(kiss_state);
  for (int i = 1; i < nseed; ++i) tmp[i] = kiss64_raw(kiss_state);
  if (m->algorithm == 1) {
    while (tmp[1] == 0) tmp[1] = kiss64_raw(kiss_state);
    while (tmp[0] == 0 && tmp[3] == 0) {
      tmp[0] = kiss64_raw(kiss_state);
      tmp[3] = kiss64_raw(kiss_state);
    }
  } else if (m->algorithm == 3) {
    // intended correction of the reference's aliasing slip (:346-348),
    // matching the Python module
    while (tmp[20634] == 0) tmp[20634] = kiss64_raw(kiss_state);
  }
  std::memcpy(m->seeds, tmp, sizeof(tmp));
  set_start_index(m);
}

inline double to_real(uint64_t u) {
  return (double)(int64_t)u / MAX_U64 + 0.5;
}

}  // namespace

extern "C" {

void* mr_create(int algorithm, int seed_type, long mype, int warmup) {
  if (algorithm < 1 || algorithm > 3) return nullptr;
  MR* m = new MR();
  m->algorithm = algorithm;
  m->nseed = algorithm == 1 ? 4 : (algorithm == 2 ? 312 : 20635);
  std::memset(m->seeds, 0, sizeof(m->seeds));
  m->has_gauss = false;
  m->gauss_buf = 0.0;
  init_seeds(m, seed_type, mype);
  for (long i = 0; i < (long)warmup * m->nseed; ++i) draw64(m);
  return m;
}

void mr_destroy(void* h) { delete (MR*)h; }

unsigned long long mr_int64(void* h) { return draw64((MR*)h); }

void mr_real_array(void* h, double* out, long n) {
  MR* m = (MR*)h;
  for (long i = 0; i < n; ++i) out[i] = to_real(draw64(m));
}

void mr_gaussian_array(void* h, double* out, long n) {
  MR* m = (MR*)h;
  long i = 0;
  if (m->has_gauss && n > 0) {
    out[0] = m->gauss_buf;
    m->has_gauss = false;
    i = 1;
  }
  while (i < n) {
    double x, y, s;
    do {
      x = (double)(int64_t)draw64(m) / MAX_I64;
      y = (double)(int64_t)draw64(m) / MAX_I64;
      s = x * x + y * y;
    } while (!(s > 0.0 && s < 1.0));
    double f = std::sqrt(-2.0 * std::log(s) / s);
    out[i] = f * x;
    if (i + 1 < n) {
      out[i + 1] = f * y;
    } else {
      m->gauss_buf = f * y;
      m->has_gauss = true;
    }
    i += 2;
  }
}

}  // extern "C"
