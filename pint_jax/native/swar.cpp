// Native host-side SWAR kernel library for pint-jax.
//
// Role in the framework: the host data path (packing control buffers,
// unpacking telemetry, CPU-side verification sweeps) should not pay Python
// or JAX dispatch overhead per buffer.  This library provides the same
// branch-free packed-lane semantics as pint_jax.ops.word, vectorized over
// contiguous buffers, auto-vectorized by the C++ compiler onto host SIMD.
//
// Architecture note (vs the reference, /root/reference/include/pint/pint.hpp):
// the reference derives masks at *C++ compile time* from template parameter
// packs; here the lane configuration is a *runtime* descriptor (PintLayout)
// initialized once per layout, so one binary serves every lane geometry --
// the idiomatic choice for a library driven from Python.  The whole-word
// bit-trick formulas implement the same published SWAR identities
// (pint.hpp:375-407, 544-590, 826-1029) on top of that runtime descriptor.
//
// Exported ABI: plain C, one function per (op, word size); Python binds via
// ctypes (pint_jax/native/__init__.py).

#include <cstdint>
#include <cstddef>

namespace {

constexpr int kMaxTerms = 64;

struct Layout {
  uint64_t hi_mask;
  uint64_t lo_mask;
  uint64_t body_mask;   // ~hi & used
  uint64_t used_mask;
  int word_bits;
  int max_width;
  // saturation dispatch: OR of (carries >> shift) & mask terms
  int n_terms;
  int shifts[kMaxTerms];
  uint64_t masks[kMaxTerms];        // all-ones = no masking for that term
  // per-width groups for heterogeneous lane shifts: (width, lo-mask) pairs
  int n_groups;
  int group_width[kMaxTerms];
  uint64_t group_mask[kMaxTerms];
};

// NT template parameter: the saturation-dispatch term count as a
// compile-time constant (NT = -1 -> runtime l.n_terms).  The buffer entry
// points switch on l->n_terms ONCE per call and run a loop whose body has
// a constant trip count, so the compiler unrolls it and auto-vectorizes
// the word loop -- measured 4-7x on the saturating ops vs the runtime
// bound (BENCH_host.json), which otherwise lose to a naive unrolled clamp.
template <class T, int NT = -1>
inline T dispatch(const Layout& l, T bits) {
  T d = 0;
  const int n = NT < 0 ? l.n_terms : NT;
  for (int i = 0; i < n; ++i)
    d |= (bits >> l.shifts[i]) & static_cast<T>(l.masks[i]);
  return d;
}

template <class T, int NT = -1>
inline T smear(const Layout& l, T carries) {
  return static_cast<T>((carries << 1) - dispatch<T, NT>(l, carries));
}

template <class T> inline T carry_add(T a, T b) {
  return (a & b) | ((a | b) & ~static_cast<T>(a + b));
}
template <class T> inline T borrow_sub(T a, T b) {
  return (~a & b) | (~(a ^ b) & static_cast<T>(a - b));
}

template <class T, int NT = -1>
inline T add_wrap1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask), m1 = static_cast<T>(l.body_mask);
  return static_cast<T>(((a & m1) + (b & m1)) ^ ((a ^ b) & m2));
}

template <class T, int NT = -1>
inline T sub_wrap1(const Layout& l, T a, T b) {
  const T m3 = static_cast<T>(l.lo_mask), m2 = static_cast<T>(l.hi_mask),
          m1 = static_cast<T>(l.body_mask);
  const T nb = static_cast<T>(~b);
  return static_cast<T>(((a & m1) + (nb & m1) + (m3 & m1)) ^ ((a ^ nb) & m2) ^
                        (m2 & m3));
}

template <class T, int NT = -1>
inline T add_usat1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  const T s = add_wrap1(l, a, b);
  return static_cast<T>(
      s | smear<T, NT>(l, static_cast<T>(carry_add(a, b) & m2)));
}

template <class T, int NT = -1>
inline T sub_usat1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask), m3 = static_cast<T>(l.lo_mask);
  const T partial = add_wrap1(l, a, static_cast<T>(~b));
  const T sat = static_cast<T>(
      partial | smear<T, NT>(l, static_cast<T>(borrow_sub(a, b) & m2)));
  return add_wrap1(l, sat, m3);
}

template <class T, int NT = -1>
inline T signed_mask(const Layout& l, T ovf) {
  return static_cast<T>(ovf - dispatch<T, NT>(l, ovf));
}

template <class T, int NT = -1>
inline T apply_ssat(const Layout& l, T total, T ovf) {
  const T m1 = signed_mask<T, NT>(l, ovf);
  const T m2 = signed_mask<T, NT>(l, static_cast<T>(ovf & ~total));
  return static_cast<T>(((total ^ ovf) | m1) ^ m2);
}

template <class T, int NT = -1>
inline T add_ssat1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  const T s = add_wrap1(l, a, b);
  const T ovf = static_cast<T>(~(a ^ b) & (s ^ b) & m2);
  return apply_ssat<T, NT>(l, s, ovf);
}

template <class T, int NT = -1>
inline T sub_ssat1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  const T d = sub_wrap1(l, a, b);
  const T ovf = static_cast<T>(((~a & b & d) | (a & ~(b | d))) & m2);
  return apply_ssat<T, NT>(l, d, ovf);
}

template <class T>
inline T interleave(T a, T b, T m) { return (a & m) | (b & ~m); }

template <class T, int NT = -1>
inline T min_u1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  return interleave(a, b,
                    smear<T, NT>(l, static_cast<T>(borrow_sub(a, b) & m2)));
}
template <class T, int NT = -1>
inline T max_u1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  return interleave(a, b,
                    smear<T, NT>(l, static_cast<T>(borrow_sub(b, a) & m2)));
}
template <class T, int NT = -1>
inline T min_s1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  return interleave(
      a, b,
      smear<T, NT>(l, static_cast<T>(borrow_sub(static_cast<T>(a ^ m2),
                                                static_cast<T>(b ^ m2)) & m2)));
}
template <class T, int NT = -1>
inline T max_s1(const Layout& l, T a, T b) {
  const T m2 = static_cast<T>(l.hi_mask);
  return interleave(
      a, b,
      smear<T, NT>(l, static_cast<T>(borrow_sub(static_cast<T>(b ^ m2),
                                                static_cast<T>(a ^ m2)) & m2)));
}

// lane shifts with runtime amount: the amount is uniform per call, so the
// per-lane masks are computed ONCE per buffer call (shl_keep / shr_keep)
// and the per-word kernel is a single AND+shift
template <class T>
inline T shl_keep(const Layout& l, unsigned amount) {
  T keep = 0;
  for (int g = 0; g < l.n_groups; ++g) {
    const T m = static_cast<T>(l.group_mask[g]);
    const unsigned w = static_cast<unsigned>(l.group_width[g]);
    const unsigned k = amount >= w ? 0u : w - amount;
    // (m << k) - m == low-k-bits-per-lane mask; k can equal word_bits only
    // for a full-width single lane, where the wraparound is exact mod 2^w
    const T shifted = (k >= sizeof(T) * 8)
                          ? 0
                          : static_cast<T>(m << k);
    keep |= static_cast<T>(shifted - m);
  }
  return keep;
}

template <class T>
inline T shr_keep(const Layout& l, unsigned amount) {
  T clear = 0;
  for (int g = 0; g < l.n_groups; ++g) {
    const T m = static_cast<T>(l.group_mask[g]);
    const unsigned w = static_cast<unsigned>(l.group_width[g]);
    const unsigned k = amount < w ? amount : w;
    clear |= static_cast<T>(static_cast<T>(m << k) - m);
  }
  return static_cast<T>(~clear);
}

template <class T>
inline T shl1(const Layout& l, T v, unsigned amount) {
  if (amount >= static_cast<unsigned>(l.max_width)) return 0;
  return static_cast<T>((shl_keep<T>(l, amount) & v) << amount);
}

template <class T>
inline T shr1(const Layout& l, T v, unsigned amount) {
  if (amount >= static_cast<unsigned>(l.max_width)) return 0;
  return static_cast<T>((shr_keep<T>(l, amount) & v) >> amount);
}

// ---- buffer runners ---------------------------------------------------------

// one switch on the dispatch-term count per CALL: inside each case the
// word loop has a compile-time-unrollable op body, which gcc/clang
// auto-vectorize (the runtime-bound fallback is 4-7x slower on the
// saturating families, BENCH_host.json)
template <class Op, class T>
inline void run_binop(const Layout& l, const T* a, const T* b, T* o,
                      size_t n) {
  switch (l.n_terms) {
#define PINT_NT_CASE(NT_)                                                  \
  case NT_:                                                                \
    for (size_t i = 0; i < n; ++i)                                         \
      o[i] = Op::template eval<T, NT_>(l, a[i], b[i]);                     \
    break;
    PINT_NT_CASE(1)
    PINT_NT_CASE(2)
    PINT_NT_CASE(3)
    PINT_NT_CASE(4)
    PINT_NT_CASE(5)
    PINT_NT_CASE(6)
    PINT_NT_CASE(7)
    PINT_NT_CASE(8)
#undef PINT_NT_CASE
    default:
      for (size_t i = 0; i < n; ++i)
        o[i] = Op::template eval<T, -1>(l, a[i], b[i]);
  }
}

#define PINT_OP_STRUCT(Name, fn)                                           \
  struct Name {                                                            \
    template <class T, int NT>                                             \
    static inline T eval(const Layout& l, T a, T b) {                      \
      return fn<T, NT>(l, a, b);                                           \
    }                                                                      \
  };

PINT_OP_STRUCT(OpAddWrap, add_wrap1)
PINT_OP_STRUCT(OpSubWrap, sub_wrap1)
PINT_OP_STRUCT(OpAddUsat, add_usat1)
PINT_OP_STRUCT(OpSubUsat, sub_usat1)
PINT_OP_STRUCT(OpAddSsat, add_ssat1)
PINT_OP_STRUCT(OpSubSsat, sub_ssat1)
PINT_OP_STRUCT(OpMinU, min_u1)
PINT_OP_STRUCT(OpMaxU, max_u1)
PINT_OP_STRUCT(OpMinS, min_s1)
PINT_OP_STRUCT(OpMaxS, max_s1)

template <class T, bool Left>
inline void run_shift(const Layout& l, const T* v, unsigned amount, T* o,
                      size_t n) {
  if (amount >= static_cast<unsigned>(l.max_width)) {
    for (size_t i = 0; i < n; ++i) o[i] = 0;
    return;
  }
  if (Left) {
    const T keep = shl_keep<T>(l, amount);
    for (size_t i = 0; i < n; ++i)
      o[i] = static_cast<T>((keep & v[i]) << amount);
  } else {
    const T keep = shr_keep<T>(l, amount);
    for (size_t i = 0; i < n; ++i)
      o[i] = static_cast<T>((keep & v[i]) >> amount);
  }
}

}  // namespace

extern "C" {

// ---- layout initialization ------------------------------------------------

// Populates a Layout from lane widths; returns 0 on success.
int pint_layout_init(const int* widths, int n_lanes, Layout* out) {
  if (n_lanes < 1 || n_lanes > kMaxTerms) return 1;
  int total = 0;
  for (int i = 0; i < n_lanes; ++i) {
    if (widths[i] < 1) return 2;
    total += widths[i];
  }
  if (total > 64) return 3;
  int wb = total <= 8 ? 8 : total <= 16 ? 16 : total <= 32 ? 32 : 64;

  uint64_t hi = 0, lo = 0;
  int off = 0, maxw = 0;
  for (int i = 0; i < n_lanes; ++i) {
    hi |= 1ull << (off + widths[i] - 1);
    lo |= 1ull << off;
    off += widths[i];
    if (widths[i] > maxw) maxw = widths[i];
  }
  const uint64_t used = total == 64 ? ~0ull : (1ull << total) - 1;
  out->hi_mask = hi;
  out->lo_mask = lo;
  out->used_mask = used;
  out->body_mask = ~hi & used;
  out->word_bits = wb;
  out->max_width = maxw;

  // per-width groups (doubles as the general saturation dispatch)
  out->n_groups = 0;
  for (int i = 0; i < n_lanes; ++i) {
    int g = -1;
    for (int j = 0; j < out->n_groups; ++j)
      if (out->group_width[j] == widths[i]) { g = j; break; }
    if (g < 0) {
      g = out->n_groups++;
      out->group_width[g] = widths[i];
      out->group_mask[g] = 0;
    }
  }
  off = 0;
  for (int i = 0; i < n_lanes; ++i) {
    for (int j = 0; j < out->n_groups; ++j)
      if (out->group_width[j] == widths[i])
        out->group_mask[j] |= 1ull << off;
    off += widths[i];
  }
  // dispatch terms: the general per-width form (always correct; the
  // uniform/type-1 special cases of the reference are pure op-count
  // optimizations that the compiler's constant folding makes moot here)
  out->n_terms = out->n_groups;
  for (int j = 0; j < out->n_groups; ++j) {
    out->shifts[j] = out->group_width[j] - 1;
    out->masks[j] = out->group_mask[j];
  }
  return 0;
}

// ---- buffer kernels -------------------------------------------------------

#define PINT_BINOP(name, OpS)                                                 \
  void pint_##name##_u8(const Layout* l, const uint8_t* a, const uint8_t* b,  \
                        uint8_t* o, size_t n) {                               \
    run_binop<OpS>(*l, a, b, o, n);                                           \
  }                                                                           \
  void pint_##name##_u16(const Layout* l, const uint16_t* a,                  \
                         const uint16_t* b, uint16_t* o, size_t n) {          \
    run_binop<OpS>(*l, a, b, o, n);                                           \
  }                                                                           \
  void pint_##name##_u32(const Layout* l, const uint32_t* a,                  \
                         const uint32_t* b, uint32_t* o, size_t n) {          \
    run_binop<OpS>(*l, a, b, o, n);                                           \
  }                                                                           \
  void pint_##name##_u64(const Layout* l, const uint64_t* a,                  \
                         const uint64_t* b, uint64_t* o, size_t n) {          \
    run_binop<OpS>(*l, a, b, o, n);                                           \
  }

PINT_BINOP(add_wrap, OpAddWrap)
PINT_BINOP(sub_wrap, OpSubWrap)
PINT_BINOP(add_unsigned_saturate, OpAddUsat)
PINT_BINOP(sub_unsigned_saturate, OpSubUsat)
PINT_BINOP(add_signed_saturate, OpAddSsat)
PINT_BINOP(sub_signed_saturate, OpSubSsat)
PINT_BINOP(min_unsigned, OpMinU)
PINT_BINOP(max_unsigned, OpMaxU)
PINT_BINOP(min_signed, OpMinS)
PINT_BINOP(max_signed, OpMaxS)

#define PINT_SHIFT(name, left)                                                \
  void pint_##name##_u8(const Layout* l, const uint8_t* v, unsigned amount,   \
                        uint8_t* o, size_t n) {                               \
    run_shift<uint8_t, left>(*l, v, amount, o, n);                            \
  }                                                                           \
  void pint_##name##_u16(const Layout* l, const uint16_t* v, unsigned amount, \
                         uint16_t* o, size_t n) {                             \
    run_shift<uint16_t, left>(*l, v, amount, o, n);                           \
  }                                                                           \
  void pint_##name##_u32(const Layout* l, const uint32_t* v, unsigned amount, \
                         uint32_t* o, size_t n) {                             \
    run_shift<uint32_t, left>(*l, v, amount, o, n);                           \
  }                                                                           \
  void pint_##name##_u64(const Layout* l, const uint64_t* v, unsigned amount, \
                         uint64_t* o, size_t n) {                             \
    run_shift<uint64_t, left>(*l, v, amount, o, n);                           \
  }

PINT_SHIFT(shift_left, true)
PINT_SHIFT(shift_right_unsigned, false)

// ---- pack / unpack --------------------------------------------------------
// lanes layout: lanes-last contiguous int32 per lane; used by the host data
// pipeline to stage packed control buffers

}  // extern "C" (pause: templates need C++ linkage)

template <class T, class L>
inline void pack_impl(const int* widths, int n_lanes, const L* lanes,
                      T* words, size_t n_words) {
  for (size_t i = 0; i < n_words; ++i) {
    uint64_t w = 0;
    int off = 0;
    for (int j = 0; j < n_lanes; ++j) {
      const uint64_t ones =
          (widths[j] >= 64) ? ~0ull : ((1ull << widths[j]) - 1ull);
      w |= (static_cast<uint64_t>(lanes[i * n_lanes + j]) & ones) << off;
      off += widths[j];
    }
    words[i] = static_cast<T>(w);
  }
}

template <class T, class L>
inline void unpack_impl(const int* widths, int n_lanes, const T* words,
                        L* lanes, size_t n_words, bool sign) {
  for (size_t i = 0; i < n_words; ++i) {
    const uint64_t word = static_cast<uint64_t>(words[i]);
    int off = 0;
    for (int j = 0; j < n_lanes; ++j) {
      const int w = widths[j];
      if (sign) {
        // sign-extend in 64-bit space regardless of word size
        lanes[i * n_lanes + j] = static_cast<L>(
            static_cast<int64_t>(word << (64 - off - w)) >> (64 - w));
      } else {
        const uint64_t ones = (w >= 64) ? ~0ull : ((1ull << w) - 1ull);
        lanes[i * n_lanes + j] = static_cast<L>((word >> off) & ones);
      }
      off += w;
    }
  }
}

extern "C" {

// pint.hpp ctor/get work at every Integer width (pint.hpp:768-774,
// 799-822); the buffer entry points mirror that: one symbol per word
// size, int32 lane buffers below 64-bit words, int64 lanes for u64.
#define PINT_PACK_FAMILY(sfx, T, L)                                          \
  void pint_pack_##sfx(const Layout* l, const int* widths, int n_lanes,      \
                       const L* lanes, T* words, size_t n_words) {           \
    (void)l;                                                                 \
    pack_impl<T, L>(widths, n_lanes, lanes, words, n_words);                 \
  }                                                                          \
  void pint_unpack_##sfx(const Layout* l, const int* widths, int n_lanes,    \
                         const T* words, L* lanes, size_t n_words) {         \
    (void)l;                                                                 \
    unpack_impl<T, L>(widths, n_lanes, words, lanes, n_words, false);        \
  }                                                                          \
  void pint_unpack_signed_##sfx(const Layout* l, const int* widths,          \
                                int n_lanes, const T* words, L* lanes,       \
                                size_t n_words) {                            \
    (void)l;                                                                 \
    unpack_impl<T, L>(widths, n_lanes, words, lanes, n_words, true);         \
  }

PINT_PACK_FAMILY(u8, uint8_t, int32_t)
PINT_PACK_FAMILY(u16, uint16_t, int32_t)
PINT_PACK_FAMILY(u32, uint32_t, int32_t)
PINT_PACK_FAMILY(u64, uint64_t, int64_t)

int pint_layout_sizeof() { return static_cast<int>(sizeof(Layout)); }

}  // extern "C"
