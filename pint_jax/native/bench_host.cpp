// Host-native comparison bench for the pint-jax C++ SWAR tier.
//
// Re-creates the reference's benchmark MATRIX (tests/pint_bench.cpp:85-684:
// packed ops vs naive per-field bitshift, bitfield-union wrap, branchy
// saturate, uclamp/sclamp unions, and SSE2/NEON intrinsics, over the same
// lane configs) as a standalone binary emitting one JSON line per row.
// The baseline *semantics* are ported, not the code: every baseline is
// verified against the packed kernel on a sample before timing, so a
// mis-ported baseline aborts the run instead of producing a bogus row.
//
// Methodology (mirrors the reference harness, pint_bench.cpp:59-95):
// per-pair loop over a DRAM-resident array (working set is sized ~1.5x the
// L3 at build time), result accumulated into a register (no stores) with
// the checksum published to defeat dead-code elimination; items/s = word
// pairs per second.  Additionally, each packed family gets a
// "pint_buffer" row timing the shipped C ABI (pint_*_u32 buffer kernels,
// stores included) -- the number the host data pipeline actually sees.
// 5 repetitions per row; min/median/max reported.

#include "swar.cpp"  // the library under test (anonymous-namespace kernels + C ABI)

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif
#ifdef __ARM_NEON
#include <arm_neon.h>
#endif

namespace {

volatile uint64_t g_sink;  // checksum sink (anti-DCE)

using Clock = std::chrono::steady_clock;

double now_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

// ---- configs ---------------------------------------------------------------

template <int N>
struct CW {
  unsigned w[N];
  unsigned off[N];
};

template <int N>
constexpr CW<N> make_cw(const unsigned (&ws)[N]) {
  CW<N> c{};
  unsigned off = 0;
  for (int i = 0; i < N; ++i) {
    c.w[i] = ws[i];
    c.off[i] = off;
    off += ws[i];
  }
  return c;
}

constexpr unsigned kHet7W[7] = {1, 2, 3, 4, 5, 6, 11};
constexpr unsigned kHet4W[4] = {1, 3, 5, 11};
constexpr unsigned kEq4W[4] = {8, 8, 8, 8};
constexpr auto kHet7 = make_cw(kHet7W);
constexpr auto kHet4 = make_cw(kHet4W);
constexpr auto kEq4 = make_cw(kEq4W);

// ---- naive per-field bitshift baselines (pint_bench.cpp:97-115 semantics) --

template <int N>
inline uint32_t naive_add(const CW<N>& c, uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < N; ++i) {
    const uint32_t m = (1u << c.w[i]) - 1u;
    const uint32_t s = ((a >> c.off[i]) & m) + ((b >> c.off[i]) & m);
    r |= (s & m) << c.off[i];
  }
  return r;
}

template <int N>
inline uint32_t naive_add_usat(const CW<N>& c, uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < N; ++i) {
    const uint32_t m = (1u << c.w[i]) - 1u;
    uint32_t s = ((a >> c.off[i]) & m) + ((b >> c.off[i]) & m);
    if (s > m) s = m;  // branchy saturate
    r |= s << c.off[i];
  }
  return r;
}

template <int N>
inline uint32_t naive_add_uclamp(const CW<N>& c, uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < N; ++i) {
    const uint32_t m = (1u << c.w[i]) - 1u;
    const uint32_t s = std::min(
        ((a >> c.off[i]) & m) + ((b >> c.off[i]) & m), m);
    r |= s << c.off[i];
  }
  return r;
}

template <int N>
inline uint32_t naive_add_sclamp(const CW<N>& c, uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < N; ++i) {
    const unsigned w = c.w[i];
    const uint32_t m = (1u << w) - 1u;
    const int32_t lo = -(1 << (w - 1)), hi = (1 << (w - 1)) - 1;
    // sign-extend each field, add, clamp
    const int32_t ax = (int32_t)(((a >> c.off[i]) & m) << (32 - w)) >> (32 - w);
    const int32_t bx = (int32_t)(((b >> c.off[i]) & m) << (32 - w)) >> (32 - w);
    const int32_t s = std::min(std::max(ax + bx, lo), hi);
    r |= ((uint32_t)s & m) << c.off[i];
  }
  return r;
}

// ---- bitfield-union baselines (pint_bench.cpp:117-151 semantics) -----------

union UHet7 {
  uint32_t v;
  struct { uint32_t l0:1, l1:2, l2:3, l3:4, l4:5, l5:6, l6:11; } f;
};
union UHet4 {
  uint32_t v;
  struct { uint32_t l0:1, l1:3, l2:5, l3:11; } f;
};
union UEq4 {
  uint32_t v;
  struct { uint32_t l0:8, l1:8, l2:8, l3:8; } f;
};
union SHet7 {
  uint32_t v;
  struct { int32_t l0:1, l1:2, l2:3, l3:4, l4:5, l5:6, l6:11; } f;
};
union SEq4 {
  uint32_t v;
  struct { int32_t l0:8, l1:8, l2:8, l3:8; } f;
};
union UQuad64 {
  uint64_t v;
  struct { uint64_t l0:8, l1:8, l2:8, l3:8, l4:8, l5:8, l6:8, l7:8; } f;
};

#define UNION_ADD_FIELD(name) r.f.name = x.f.name + y.f.name;
#define UNION_USAT_FIELD(name, bits)                            \
  {                                                             \
    const uint32_t m = (1u << (bits)) - 1u;                     \
    uint32_t s = (uint32_t)x.f.name + (uint32_t)y.f.name;       \
    if (s > m) s = m;                                           \
    r.f.name = s;                                               \
  }
#define UNION_UCLAMP_FIELD(name, bits)                          \
  r.f.name = std::min<uint32_t>(                                \
      (uint32_t)x.f.name + (uint32_t)y.f.name, (1u << (bits)) - 1u);
#define UNION_SCLAMP_FIELD(name, bits)                          \
  r.f.name = std::min(std::max((int32_t)x.f.name + (int32_t)y.f.name, \
                               -(1 << ((bits) - 1))),           \
                      (1 << ((bits) - 1)) - 1);

inline uint32_t union_add_het7(uint32_t a, uint32_t b) {
  UHet7 x{a}, y{b}, r{0};
  UNION_ADD_FIELD(l0) UNION_ADD_FIELD(l1) UNION_ADD_FIELD(l2)
  UNION_ADD_FIELD(l3) UNION_ADD_FIELD(l4) UNION_ADD_FIELD(l5)
  UNION_ADD_FIELD(l6)
  return r.v;
}
inline uint32_t union_sub_het7(uint32_t a, uint32_t b) {
  UHet7 x{a}, y{b}, r{0};
  r.f.l0 = x.f.l0 - y.f.l0; r.f.l1 = x.f.l1 - y.f.l1;
  r.f.l2 = x.f.l2 - y.f.l2; r.f.l3 = x.f.l3 - y.f.l3;
  r.f.l4 = x.f.l4 - y.f.l4; r.f.l5 = x.f.l5 - y.f.l5;
  r.f.l6 = x.f.l6 - y.f.l6;
  return r.v;
}
inline uint32_t union_add_eq4(uint32_t a, uint32_t b) {
  UEq4 x{a}, y{b}, r{0};
  UNION_ADD_FIELD(l0) UNION_ADD_FIELD(l1) UNION_ADD_FIELD(l2)
  UNION_ADD_FIELD(l3)
  return r.v;
}
inline uint32_t union_usat_het7(uint32_t a, uint32_t b) {
  UHet7 x{a}, y{b}, r{0};
  UNION_USAT_FIELD(l0, 1) UNION_USAT_FIELD(l1, 2) UNION_USAT_FIELD(l2, 3)
  UNION_USAT_FIELD(l3, 4) UNION_USAT_FIELD(l4, 5) UNION_USAT_FIELD(l5, 6)
  UNION_USAT_FIELD(l6, 11)
  return r.v;
}
inline uint32_t union_uclamp_het7(uint32_t a, uint32_t b) {
  UHet7 x{a}, y{b}, r{0};
  UNION_UCLAMP_FIELD(l0, 1) UNION_UCLAMP_FIELD(l1, 2) UNION_UCLAMP_FIELD(l2, 3)
  UNION_UCLAMP_FIELD(l3, 4) UNION_UCLAMP_FIELD(l4, 5) UNION_UCLAMP_FIELD(l5, 6)
  UNION_UCLAMP_FIELD(l6, 11)
  return r.v;
}
inline uint32_t union_usat_het4(uint32_t a, uint32_t b) {
  UHet4 x{a}, y{b}, r{0};
  UNION_USAT_FIELD(l0, 1) UNION_USAT_FIELD(l1, 3) UNION_USAT_FIELD(l2, 5)
  UNION_USAT_FIELD(l3, 11)
  return r.v;
}
inline uint32_t union_uclamp_het4(uint32_t a, uint32_t b) {
  UHet4 x{a}, y{b}, r{0};
  UNION_UCLAMP_FIELD(l0, 1) UNION_UCLAMP_FIELD(l1, 3) UNION_UCLAMP_FIELD(l2, 5)
  UNION_UCLAMP_FIELD(l3, 11)
  return r.v;
}
inline uint32_t union_uclamp_eq4(uint32_t a, uint32_t b) {
  UEq4 x{a}, y{b}, r{0};
  UNION_UCLAMP_FIELD(l0, 8) UNION_UCLAMP_FIELD(l1, 8) UNION_UCLAMP_FIELD(l2, 8)
  UNION_UCLAMP_FIELD(l3, 8)
  return r.v;
}
inline uint32_t union_sclamp_het7(uint32_t a, uint32_t b) {
  SHet7 x{a}, y{b}, r{0};
  UNION_SCLAMP_FIELD(l0, 1) UNION_SCLAMP_FIELD(l1, 2) UNION_SCLAMP_FIELD(l2, 3)
  UNION_SCLAMP_FIELD(l3, 4) UNION_SCLAMP_FIELD(l4, 5) UNION_SCLAMP_FIELD(l5, 6)
  UNION_SCLAMP_FIELD(l6, 11)
  return r.v;
}
inline uint32_t union_sclamp_eq4(uint32_t a, uint32_t b) {
  SEq4 x{a}, y{b}, r{0};
  UNION_SCLAMP_FIELD(l0, 8) UNION_SCLAMP_FIELD(l1, 8) UNION_SCLAMP_FIELD(l2, 8)
  UNION_SCLAMP_FIELD(l3, 8)
  return r.v;
}
inline uint64_t union_uclamp_quad64(uint64_t a, uint64_t b) {
  UQuad64 x{a}, y{b}, r{0};
  UNION_UCLAMP_FIELD(l0, 8) UNION_UCLAMP_FIELD(l1, 8) UNION_UCLAMP_FIELD(l2, 8)
  UNION_UCLAMP_FIELD(l3, 8) UNION_UCLAMP_FIELD(l4, 8) UNION_UCLAMP_FIELD(l5, 8)
  UNION_UCLAMP_FIELD(l6, 8) UNION_UCLAMP_FIELD(l7, 8)
  return r.v;
}

// ---- harness ----------------------------------------------------------------

struct Rates {
  double med, lo, hi;
};

template <class Body>
Rates time_reps(Body&& body, size_t items_per_pass) {
  body();  // warmup (page-in + icache)
  double rates[5];
  for (int rep = 0; rep < 5; ++rep) {
    const double t0 = now_s();
    int passes = 0;
    double el;
    do {
      body();
      ++passes;
      el = now_s() - t0;
    } while (el < 0.2);
    rates[rep] = (double)items_per_pass * passes / el;
  }
  std::sort(rates, rates + 5);
  return {rates[2], rates[0], rates[4]};
}

void emit(const char* family, const char* config, const char* impl,
          Rates r) {
  std::printf(
      "{\"family\": \"%s\", \"config\": \"%s\", \"impl\": \"%s\", "
      "\"words_per_s\": %.4g, \"min\": %.4g, \"max\": %.4g}\n",
      family, config, impl, r.med, r.lo, r.hi);
  std::fflush(stdout);
}

// per-pair register-accumulate loop (reference style: no stores)
template <class T, class Op>
uint64_t pair_loop(const T* a, const T* b, size_t n, Op op) {
  T acc = 0;
  for (size_t i = 0; i < n; ++i) acc ^= op(a[i], b[i]);
  return (uint64_t)acc;
}

}  // namespace

// sanity: baseline must agree with the packed kernel where semantics match
template <class T, class OpA, class OpB>
static void must_match(const char* what, const T* a, const T* b, size_t n,
                       OpA lhs, OpB rhs) {
  for (size_t i = 0; i < n; ++i) {
    const T x = lhs(a[i], b[i]), y = rhs(a[i], b[i]);
    if (x != y) {
      std::fprintf(stderr,
                   "MISMATCH %s at %zu: a=%llx b=%llx lhs=%llx rhs=%llx\n",
                   what, i, (unsigned long long)a[i], (unsigned long long)b[i],
                   (unsigned long long)x, (unsigned long long)y);
      std::exit(1);
    }
  }
}

int main() {
  // DRAM-resident working set: this host has a 260 MiB L3, so use 48M u32
  // pairs (384 MiB of reads) and 24M u64 pairs
  const size_t N32 = size_t(48) << 20;
  const size_t N64 = size_t(24) << 20;
  const size_t NCHK = 1 << 16;

  std::mt19937_64 rng(0xC0FFEE);
  std::vector<uint32_t> a32(N32), b32(N32), o32(N32);
  for (size_t i = 0; i < N32; ++i) {
    a32[i] = (uint32_t)rng();
    b32[i] = (uint32_t)rng();
  }
  std::vector<uint64_t> a64(N64), b64(N64), o64(N64);
  for (size_t i = 0; i < N64; ++i) {
    a64[i] = rng();
    b64[i] = rng();
  }

  Layout het7, het4, eq4, quad64;
  {
    const int w7[7] = {1, 2, 3, 4, 5, 6, 11};
    const int w4[4] = {1, 3, 5, 11};
    const int e4[4] = {8, 8, 8, 8};
    const int q8[8] = {8, 8, 8, 8, 8, 8, 8, 8};
    if (pint_layout_init(w7, 7, &het7) || pint_layout_init(w4, 4, &het4) ||
        pint_layout_init(e4, 4, &eq4) || pint_layout_init(q8, 8, &quad64)) {
      std::fprintf(stderr, "layout init failed\n");
      return 1;
    }
  }

  // canonical-word contract: mask the 20-bit config's inputs to used bits
  std::vector<uint32_t> a20(N32), b20(N32);
  for (size_t i = 0; i < N32; ++i) {
    a20[i] = a32[i] & (uint32_t)het4.used_mask;
    b20[i] = b32[i] & (uint32_t)het4.used_mask;
  }

  const uint32_t* A = a32.data();
  const uint32_t* B = b32.data();
  const uint32_t* A20 = a20.data();
  const uint32_t* B20 = b20.data();
  uint32_t* O = o32.data();

  // ---- semantic cross-checks (baseline == packed kernel) -------------------
  must_match<uint32_t>("add_wrap het7 naive", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_wrap1<uint32_t>(het7, x, y); },
      [&](uint32_t x, uint32_t y) { return naive_add<7>(kHet7, x, y); });
  must_match<uint32_t>("add_wrap het7 union", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_wrap1<uint32_t>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return union_add_het7(x, y); });
  must_match<uint32_t>("sub_wrap het7 union", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return sub_wrap1<uint32_t>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return union_sub_het7(x, y); });
  must_match<uint32_t>("add_wrap eq4 union", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_wrap1<uint32_t>(eq4, x, y); },
      [](uint32_t x, uint32_t y) { return union_add_eq4(x, y); });
  must_match<uint32_t>("add_usat het7 branchy", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 7>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return union_usat_het7(x, y); });
  must_match<uint32_t>("add_usat het7 uclamp", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 7>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return union_uclamp_het7(x, y); });
  must_match<uint32_t>("add_usat het4 branchy", A20, B20, NCHK,
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 4>(het4, x, y); },
      [](uint32_t x, uint32_t y) { return union_usat_het4(x, y); });
  must_match<uint32_t>("add_usat eq4 uclamp", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 1>(eq4, x, y); },
      [](uint32_t x, uint32_t y) { return union_uclamp_eq4(x, y); });
  must_match<uint32_t>("add_ssat het7 sclamp", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 7>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return union_sclamp_het7(x, y); });
  must_match<uint32_t>("add_ssat het7 naive", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 7>(het7, x, y); },
      [](uint32_t x, uint32_t y) { return naive_add_sclamp<7>(kHet7, x, y); });
  must_match<uint32_t>("add_ssat eq4 sclamp", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 1>(eq4, x, y); },
      [](uint32_t x, uint32_t y) { return union_sclamp_eq4(x, y); });
  must_match<uint64_t>("add_usat quad64 uclamp", a64.data(), b64.data(), NCHK,
      [&](uint64_t x, uint64_t y) { return add_usat1<uint64_t, 1>(quad64, x, y); },
      [](uint64_t x, uint64_t y) { return union_uclamp_quad64(x, y); });
#ifdef __SSE2__
  {
    // SSE2 lanewise ops on 4 packed words at a time must equal the kernel
    for (size_t i = 0; i + 4 <= NCHK; i += 4) {
      alignas(16) uint32_t ref[4], got[4];
      __m128i va = _mm_loadu_si128((const __m128i*)(A + i));
      __m128i vb = _mm_loadu_si128((const __m128i*)(B + i));
      _mm_store_si128((__m128i*)got, _mm_add_epi8(va, vb));
      for (int k = 0; k < 4; ++k) ref[k] = add_wrap1<uint32_t>(eq4, A[i+k], B[i+k]);
      if (std::memcmp(ref, got, 16)) { std::fprintf(stderr, "SSE2 add mismatch\n"); return 1; }
      _mm_store_si128((__m128i*)got, _mm_adds_epu8(va, vb));
      for (int k = 0; k < 4; ++k) ref[k] = add_usat1<uint32_t, 1>(eq4, A[i+k], B[i+k]);
      if (std::memcmp(ref, got, 16)) { std::fprintf(stderr, "SSE2 adds_epu8 mismatch\n"); return 1; }
      _mm_store_si128((__m128i*)got, _mm_adds_epi8(va, vb));
      for (int k = 0; k < 4; ++k) ref[k] = add_ssat1<uint32_t, 1>(eq4, A[i+k], B[i+k]);
      if (std::memcmp(ref, got, 16)) { std::fprintf(stderr, "SSE2 adds_epi8 mismatch\n"); return 1; }
    }
  }
#endif
  must_match<uint32_t>("usat het7 NT==runtime", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 7>(het7, x, y); },
      [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, -1>(het7, x, y); });
  must_match<uint32_t>("ssat het7 NT==runtime", A, B, NCHK,
      [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 7>(het7, x, y); },
      [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, -1>(het7, x, y); });
  std::fprintf(stderr, "cross-checks OK (%zu pairs per family)\n", NCHK);

  // ---- calibration ----------------------------------------------------------
  emit("Baseline", "u32", "raw_add",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return x + y; }); }, N32));

  struct FamRow {
    const char* family;
    const char* config;
    const char* impl;
    uint64_t (*unused)(void);
  };

  // ---- AddWrap het7 ---------------------------------------------------------
  emit("AddWrap", "1,2,3,4,5,6,11", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_wrap1<uint32_t>(het7, x, y); }); }, N32));
  emit("AddWrap", "1,2,3,4,5,6,11", "pint_buffer",
       time_reps([&] { pint_add_wrap_u32(&het7, A, B, O, N32); g_sink += O[12345]; }, N32));
  emit("AddWrap", "1,2,3,4,5,6,11", "naive_bitshift",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return naive_add<7>(kHet7, x, y); }); }, N32));
  emit("AddWrap", "1,2,3,4,5,6,11", "union_bitfield",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_add_het7(x, y); }); }, N32));

  // ---- AddWrap0 eq4 (vs SIMD) -----------------------------------------------
  emit("AddWrap0", "8,8,8,8", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_wrap1<uint32_t>(eq4, x, y); }); }, N32));
  emit("AddWrap0", "8,8,8,8", "pint_buffer",
       time_reps([&] { pint_add_wrap_u32(&eq4, A, B, O, N32); g_sink += O[12345]; }, N32));
  emit("AddWrap0", "8,8,8,8", "union_bitfield",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_add_eq4(x, y); }); }, N32));
  emit("AddWrap0", "8,8,8,8", "naive_bitshift",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return naive_add<4>(kEq4, x, y); }); }, N32));
#ifdef __SSE2__
  emit("AddWrap0", "8,8,8,8", "sse2_add_epi8",
       time_reps([&] {
         __m128i acc = _mm_setzero_si128();
         for (size_t i = 0; i + 4 <= N32; i += 4)
           acc = _mm_xor_si128(acc, _mm_add_epi8(
               _mm_loadu_si128((const __m128i*)(A + i)),
               _mm_loadu_si128((const __m128i*)(B + i))));
         alignas(16) uint64_t out[2];
         _mm_store_si128((__m128i*)out, acc);
         g_sink += out[0] ^ out[1];
       }, N32));
#endif

  // ---- SubWrap het7 -----------------------------------------------------------
  emit("SubWrap", "1,2,3,4,5,6,11", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return sub_wrap1<uint32_t>(het7, x, y); }); }, N32));
  emit("SubWrap", "1,2,3,4,5,6,11", "pint_buffer",
       time_reps([&] { pint_sub_wrap_u32(&het7, A, B, O, N32); g_sink += O[999]; }, N32));
  emit("SubWrap", "1,2,3,4,5,6,11", "union_bitfield",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_sub_het7(x, y); }); }, N32));

  // ---- AddSatU2 het7 ----------------------------------------------------------
  emit("AddSatU2", "1,2,3,4,5,6,11", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 7>(het7, x, y); }); }, N32));
  emit("AddSatU2", "1,2,3,4,5,6,11", "pint_buffer",
       time_reps([&] { pint_add_unsigned_saturate_u32(&het7, A, B, O, N32); g_sink += O[777]; }, N32));
  emit("AddSatU2", "1,2,3,4,5,6,11", "union_branchy",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_usat_het7(x, y); }); }, N32));
  emit("AddSatU2", "1,2,3,4,5,6,11", "union_uclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_uclamp_het7(x, y); }); }, N32));
  emit("AddSatU2", "1,2,3,4,5,6,11", "naive_uclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return naive_add_uclamp<7>(kHet7, x, y); }); }, N32));

  // ---- AddSatU1 het4 (20-bit words) -------------------------------------------
  emit("AddSatU1", "1,3,5,11", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A20, B20, N32,
           [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 4>(het4, x, y); }); }, N32));
  emit("AddSatU1", "1,3,5,11", "pint_buffer",
       time_reps([&] { pint_add_unsigned_saturate_u32(&het4, A20, B20, O, N32); g_sink += O[555]; }, N32));
  emit("AddSatU1", "1,3,5,11", "union_branchy",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A20, B20, N32,
           [](uint32_t x, uint32_t y) { return union_usat_het4(x, y); }); }, N32));
  emit("AddSatU1", "1,3,5,11", "union_uclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A20, B20, N32,
           [](uint32_t x, uint32_t y) { return union_uclamp_het4(x, y); }); }, N32));

  // ---- AddSatU0 eq4 (vs SIMD) ---------------------------------------------------
  emit("AddSatU0", "8,8,8,8", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_usat1<uint32_t, 1>(eq4, x, y); }); }, N32));
  emit("AddSatU0", "8,8,8,8", "pint_buffer",
       time_reps([&] { pint_add_unsigned_saturate_u32(&eq4, A, B, O, N32); g_sink += O[333]; }, N32));
  emit("AddSatU0", "8,8,8,8", "union_uclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_uclamp_eq4(x, y); }); }, N32));
#ifdef __SSE2__
  emit("AddSatU0", "8,8,8,8", "sse2_adds_epu8",
       time_reps([&] {
         __m128i acc = _mm_setzero_si128();
         for (size_t i = 0; i + 4 <= N32; i += 4)
           acc = _mm_xor_si128(acc, _mm_adds_epu8(
               _mm_loadu_si128((const __m128i*)(A + i)),
               _mm_loadu_si128((const __m128i*)(B + i))));
         alignas(16) uint64_t out[2];
         _mm_store_si128((__m128i*)out, acc);
         g_sink += out[0] ^ out[1];
       }, N32));
#endif

  // ---- AddSatU0 u64 8x8 ---------------------------------------------------------
  emit("AddSatU0w64", "8x8 u64", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint64_t>(a64.data(), b64.data(), N64,
           [&](uint64_t x, uint64_t y) { return add_usat1<uint64_t, 1>(quad64, x, y); }); }, N64));
  emit("AddSatU0w64", "8x8 u64", "pint_buffer",
       time_reps([&] { pint_add_unsigned_saturate_u64(&quad64, a64.data(), b64.data(), o64.data(), N64); g_sink += o64[111]; }, N64));
  emit("AddSatU0w64", "8x8 u64", "union_uclamp",
       time_reps([&] { g_sink += pair_loop<uint64_t>(a64.data(), b64.data(), N64,
           [](uint64_t x, uint64_t y) { return union_uclamp_quad64(x, y); }); }, N64));
#ifdef __SSE2__
  emit("AddSatU0w64", "8x8 u64", "sse2_adds_epu8",
       time_reps([&] {
         __m128i acc = _mm_setzero_si128();
         const uint64_t* pa = a64.data();
         const uint64_t* pb = b64.data();
         for (size_t i = 0; i + 2 <= N64; i += 2)
           acc = _mm_xor_si128(acc, _mm_adds_epu8(
               _mm_loadu_si128((const __m128i*)(pa + i)),
               _mm_loadu_si128((const __m128i*)(pb + i))));
         alignas(16) uint64_t out[2];
         _mm_store_si128((__m128i*)out, acc);
         g_sink += out[0] ^ out[1];
       }, N64));
#endif

  // ---- AddSatS2 het7 --------------------------------------------------------------
  emit("AddSatS2", "1,2,3,4,5,6,11", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 7>(het7, x, y); }); }, N32));
  emit("AddSatS2", "1,2,3,4,5,6,11", "pint_buffer",
       time_reps([&] { pint_add_signed_saturate_u32(&het7, A, B, O, N32); g_sink += O[222]; }, N32));
  emit("AddSatS2", "1,2,3,4,5,6,11", "union_sclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_sclamp_het7(x, y); }); }, N32));
  emit("AddSatS2", "1,2,3,4,5,6,11", "naive_sclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return naive_add_sclamp<7>(kHet7, x, y); }); }, N32));

  // ---- AddSatS0 eq4 -----------------------------------------------------------------
  emit("AddSatS0", "8,8,8,8", "pint_inline",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [&](uint32_t x, uint32_t y) { return add_ssat1<uint32_t, 1>(eq4, x, y); }); }, N32));
  emit("AddSatS0", "8,8,8,8", "pint_buffer",
       time_reps([&] { pint_add_signed_saturate_u32(&eq4, A, B, O, N32); g_sink += O[444]; }, N32));
  emit("AddSatS0", "8,8,8,8", "union_sclamp",
       time_reps([&] { g_sink += pair_loop<uint32_t>(A, B, N32,
           [](uint32_t x, uint32_t y) { return union_sclamp_eq4(x, y); }); }, N32));
#ifdef __SSE2__
  emit("AddSatS0", "8,8,8,8", "sse2_adds_epi8",
       time_reps([&] {
         __m128i acc = _mm_setzero_si128();
         for (size_t i = 0; i + 4 <= N32; i += 4)
           acc = _mm_xor_si128(acc, _mm_adds_epi8(
               _mm_loadu_si128((const __m128i*)(A + i)),
               _mm_loadu_si128((const __m128i*)(B + i))));
         alignas(16) uint64_t out[2];
         _mm_store_si128((__m128i*)out, acc);
         g_sink += out[0] ^ out[1];
       }, N32));
#endif

  std::fprintf(stderr, "done (sink=%llx)\n", (unsigned long long)g_sink);
  return 0;
}
