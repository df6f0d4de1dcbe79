// Host HPC run-length-collapse kernels, shared by the ctypes library
// (fasta_reader.cpp) and the CPython extension (s2kext.cpp).
//
// Rebuild of the reference's host HPC surface (reference
// src/hpc.rs: hpc/encode_rle/encode_rle_simd).  The hot path is AVX-512:
// a shifted byte-compare builds the 64-wide keep mask and VBMI2
// compress-stores emit the kept chars (epi8) and positions (epi32/epi64)
// — the same technique as the reference's 16-wide kernel
// (src/hpc.rs:88-108) at 4x the width, without its cross-chunk fix-up
// (the mask compares against seq[i-1] directly via an unaligned load).
// Inputs >= 4 MB run a two-phase parallel pass: a count pass fixes each
// chunk's exact output offset, then all chunks compress-store in place
// concurrently (no seam fix-up: chunk c's first compare, seq[o] vs
// seq[o-1], is the same rule as the serial scan).

#pragma once

#include <immintrin.h>
#if defined(__has_include)
#if __has_include(<malloc.h>)
#include <malloc.h>
#define S2K_HAVE_MALLOC_H 1
#endif
#endif

#include <algorithm>
#include <array>
#include <cassert>
#include <cstdint>
#include <thread>
#include <vector>

namespace s2k {

// thread-safe magic-static init (a plain `static bool init` flag would
// race on first concurrent calls)
inline const std::array<bool, 256>& collapsible_table() {
  static const std::array<bool, 256> t = [] {
    std::array<bool, 256> a{};
    for (const char* p = "ACTGactgNn"; *p; p++)
      a[static_cast<uint8_t>(*p)] = true;
    return a;
  }();
  return t;
}

// out_pos may be null (hpc() needs only the collapsed string).
template <typename PosT>
int64_t rle_scalar(const uint8_t* seq, int64_t i0, int64_t i1,
                   int collapse_any, uint8_t* out_chars, PosT* out_pos,
                   int64_t m) {
  const auto& coll = collapsible_table();
  for (int64_t i = i0; i < i1; i++) {
    uint8_t c = seq[i];
    if (c != seq[i - 1] || (!collapse_any && !coll[c])) {
      out_chars[m] = c;
      if (out_pos) out_pos[m] = static_cast<PosT>(i);
      m++;
    }
  }
  return m;
}

#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(__AVX512VBMI__) && defined(__AVX512VBMI2__)
#define S2K_HAVE_AVX512_RLE 1

// 128-byte collapsible LUT for the encode_rle nuance (bytes >= 128 are
// never collapsible; permutex2var indexes on the low 7 bits, so the
// high-bit lanes are masked out separately in keep_mask).
struct RleLut {
  __m512i lut0, lut1;
};

__attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vbmi2,popcnt")))
inline RleLut rle_lut() {
  alignas(64) uint8_t lut[128] = {};
  for (const char* p = "ACTGactgNn"; *p; p++)
    lut[static_cast<uint8_t>(*p)] = 1;
  return {_mm512_load_si512(lut), _mm512_load_si512(lut + 64)};
}

__attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vbmi2,popcnt")))
inline __mmask64 keep_mask(const uint8_t* seq, int64_t i, int collapse_any,
                           const RleLut& lut) {
  __m512i v = _mm512_loadu_si512(seq + i);
  __m512i p = _mm512_loadu_si512(seq + i - 1);
  __mmask64 k = _mm512_cmpneq_epi8_mask(v, p);
  if (!collapse_any) {
    __m512i cv = _mm512_permutex2var_epi8(lut.lut0, v, lut.lut1);
    __mmask64 coll =
        _mm512_test_epi8_mask(cv, cv) & ~_mm512_movepi8_mask(v);
    k |= ~coll;  // non-collapsible bytes are always kept
  }
  return k;
}

// Count-only pass: kept chars in [i0, i1) (i0 >= 1), no stores.
__attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vbmi2,popcnt")))
inline int64_t rle_count_avx512(const uint8_t* seq, int64_t i0, int64_t i1,
                                int collapse_any) {
  const RleLut lut = rle_lut();
  int64_t cnt = 0, i = i0;
  for (; i + 64 <= i1; i += 64)
    cnt += __builtin_popcountll(keep_mask(seq, i, collapse_any, lut));
  const auto& coll = collapsible_table();
  for (; i < i1; i++)
    cnt += seq[i] != seq[i - 1] || (!collapse_any && !coll[seq[i]]);
  return cnt;
}

// Compress-store pass over [i0, i1), writing from element index m.
// m_cap bounds the writable output region IN ELEMENTS: while
// m + 64 <= m_cap the fast path (register compress + full-vector store,
// overshooting by up to 64 zero elements inside the still-owned region)
// is used; otherwise the exact (microcoded, ~6x slower) compressstoreu.
// Concurrent chunk writers pass their own chunk's end so the overshoot
// never crosses into a neighbour's region.
template <typename PosT>
__attribute__((target("avx512f,avx512bw,avx512vbmi,avx512vbmi2,popcnt")))
int64_t rle_avx512(const uint8_t* seq, int64_t i0, int64_t i1,
                   int collapse_any, uint8_t* out_chars, PosT* out_pos,
                   int64_t m, int64_t m_cap) {
  const RleLut lut = rle_lut();
  const __m512i iota16 = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                           10, 11, 12, 13, 14, 15);
  const __m512i iota8 = _mm512_setr_epi64(0, 1, 2, 3, 4, 5, 6, 7);
  int64_t i = i0;
  for (; i + 64 <= i1; i += 64) {
    __mmask64 k = keep_mask(seq, i, collapse_any, lut);
    __m512i v = _mm512_loadu_si512(seq + i);
    if (m + 64 <= m_cap) {
      _mm512_storeu_si512(out_chars + m, _mm512_maskz_compress_epi8(k, v));
      if (!out_pos) {
        m += __builtin_popcountll(k);
        continue;
      }
      int64_t mq = m;
      if (sizeof(PosT) == 4) {
        for (int q = 0; q < 4; q++) {
          __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
          __m512i pos = _mm512_add_epi32(
              iota16, _mm512_set1_epi32(static_cast<int32_t>(i) + 16 * q));
          _mm512_storeu_si512(reinterpret_cast<int32_t*>(out_pos) + mq,
                              _mm512_maskz_compress_epi32(kq, pos));
          mq += __builtin_popcount(kq);
        }
      } else {
        // widen in-register: compress 32-bit window-relative offsets,
        // then cvt+add the 64-bit base (i may exceed int32 range)
        for (int q = 0; q < 4; q++) {
          __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
          __m512i rel = _mm512_add_epi32(iota16, _mm512_set1_epi32(16 * q));
          __m512i cr = _mm512_maskz_compress_epi32(kq, rel);
          __m512i base = _mm512_set1_epi64(i);
          _mm512_storeu_si512(
              reinterpret_cast<int64_t*>(out_pos) + mq,
              _mm512_add_epi64(
                  base, _mm512_cvtepu32_epi64(
                            _mm512_castsi512_si256(cr))));
          // second half stored unconditionally (overshoot stays inside the
          // still-owned m_cap region; a data-dependent branch here
          // mispredicts ~half the time at genomic keep rates)
          _mm512_storeu_si512(
              reinterpret_cast<int64_t*>(out_pos) + mq + 8,
              _mm512_add_epi64(
                  base, _mm512_cvtepu32_epi64(
                            _mm512_extracti64x4_epi64(cr, 1))));
          mq += __builtin_popcount(kq);
        }
      }
      m = mq;
      continue;
    }
    _mm512_mask_compressstoreu_epi8(out_chars + m, k, v);
    if (!out_pos) {
      m += __builtin_popcountll(k);
      continue;
    }
    int64_t mq = m;
    if (sizeof(PosT) == 4) {
      for (int q = 0; q < 4; q++) {
        __mmask16 kq = static_cast<__mmask16>(k >> (16 * q));
        __m512i pos = _mm512_add_epi32(
            iota16, _mm512_set1_epi32(static_cast<int32_t>(i) + 16 * q));
        _mm512_mask_compressstoreu_epi32(
            reinterpret_cast<int32_t*>(out_pos) + mq, kq, pos);
        mq += __builtin_popcount(kq);
      }
    } else {
      for (int q = 0; q < 8; q++) {
        __mmask8 kq = static_cast<__mmask8>(k >> (8 * q));
        __m512i pos = _mm512_add_epi64(iota8, _mm512_set1_epi64(i + 8 * q));
        _mm512_mask_compressstoreu_epi64(
            reinterpret_cast<int64_t*>(out_pos) + mq, kq, pos);
        mq += __builtin_popcount(kq);
      }
    }
    m = mq;
  }
  return rle_scalar(seq, i, i1, collapse_any, out_chars, out_pos, m);
}
#endif  // AVX-512 RLE

inline int64_t rle_count_scalar(const uint8_t* seq, int64_t i0, int64_t i1,
                                int collapse_any) {
  const auto& coll = collapsible_table();
  int64_t cnt = 0;
  for (int64_t i = i0; i < i1; i++)
    cnt += seq[i] != seq[i - 1] || (!collapse_any && !coll[seq[i]]);
  return cnt;
}

// Count/store are split so callers (the CPython extension) can allocate
// exact-size outputs up front — no over-allocation, no resize copies.
// The plan memoizes per-chunk counts from the count pass so the store
// pass runs each chunk concurrently at its exact output offset (no seam
// fix-up: chunk c's first compare, seq[lo]-vs-seq[lo-1], is the same rule
// as the serial scan).
struct RlePlan {
  int64_t total = 0;             // kept elements incl. element 0
  bool avx = false;              // AVX-512 kernels engaged
  std::vector<int64_t> lo;       // chunk bounds (parallel only)
  std::vector<int64_t> base;     // per-chunk output offsets (parallel only)
};

inline RlePlan rle_plan(const uint8_t* seq, int64_t n, int collapse_any) {
  RlePlan p;
  if (n <= 0) return p;
#if defined(S2K_HAVE_AVX512_RLE)
  if (n >= 128 && __builtin_cpu_supports("avx512vbmi2") &&
      __builtin_cpu_supports("avx512vbmi")) {
    p.avx = true;
    unsigned hw = std::thread::hardware_concurrency();
    if (n >= (4 << 20) && hw >= 2) {
      int64_t nthreads = std::min<int64_t>(hw, 4);
      p.lo.resize(nthreads + 1);
      for (int64_t t = 0; t <= nthreads; t++)
        p.lo[t] = 1 + ((n - 1) * t / nthreads & ~int64_t(63));
      p.lo[nthreads] = n;
      std::vector<int64_t> cnt(nthreads);
      {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < nthreads; t++)
          pool.emplace_back([&, t] {
            cnt[t] = rle_count_avx512(seq, p.lo[t], p.lo[t + 1],
                                      collapse_any);
          });
        cnt[0] = rle_count_avx512(seq, p.lo[0], p.lo[1], collapse_any);
        for (auto& th : pool) th.join();
      }
      p.base.resize(nthreads);
      int64_t acc = 1;  // element 0 is always kept
      for (int64_t t = 0; t < nthreads; t++) {
        p.base[t] = acc;
        acc += cnt[t];
      }
      p.total = acc;
      return p;
    }
    p.total = 1 + rle_count_avx512(seq, 1, n, collapse_any);
    return p;
  }
#endif
  p.total = 1 + rle_count_scalar(seq, 1, n, collapse_any);
  return p;
}

// Store pass into exactly plan.total elements.  out_pos may be null.
template <typename PosT>
void rle_store(const RlePlan& plan, const uint8_t* seq, int64_t n,
               int collapse_any, uint8_t* out_chars, PosT* out_pos) {
  if (n <= 0) return;
  out_chars[0] = seq[0];  // first char is always kept
  if (out_pos) out_pos[0] = 0;
#if defined(S2K_HAVE_AVX512_RLE)
  if (plan.avx) {
    if (!plan.lo.empty()) {
      int64_t nthreads = static_cast<int64_t>(plan.base.size());
      auto cap = [&](int64_t t) {  // this chunk's exclusive output end
        return t + 1 < nthreads ? plan.base[t + 1] : plan.total;
      };
      std::vector<std::thread> pool;
      for (int64_t t = 1; t < nthreads; t++)
        pool.emplace_back([&, t] {
          int64_t m = rle_avx512<PosT>(seq, plan.lo[t], plan.lo[t + 1],
                                       collapse_any, out_chars, out_pos,
                                       plan.base[t], cap(t));
          // The fast path's 64-element overshoot is safe ONLY because the
          // count pass (rle_count_avx512) and this store pass derive the
          // same keep mask, so each chunk's final m lands exactly on its
          // cap; pin that invariant so any drift between the two passes
          // fails loudly instead of stomping a neighbour chunk's output.
          assert(m == cap(t));
          (void)m;
        });
      int64_t m0 = rle_avx512<PosT>(seq, plan.lo[0], plan.lo[1],
                                    collapse_any, out_chars, out_pos,
                                    plan.base[0], cap(0));
      assert(m0 == cap(0));
      (void)m0;
      for (auto& th : pool) th.join();
      return;
    }
    rle_avx512<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1,
                     plan.total);
    return;
  }
#endif
  rle_scalar<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1);
}

// One-shot dispatch into worst-case-sized (n-element) buffers; used by the
// ctypes entry points in fasta_reader.cpp.
template <typename PosT>
int64_t rle_dispatch(const uint8_t* seq, int64_t n, int collapse_any,
                     uint8_t* out_chars, PosT* out_pos) {
  if (n <= 0) return 0;
#if defined(S2K_HAVE_AVX512_RLE)
  if (n >= 128 && n < (4 << 20) &&
      __builtin_cpu_supports("avx512vbmi2") &&
      __builtin_cpu_supports("avx512vbmi")) {
    // single-pass serial: worst-case buffers make the count pass optional
    out_chars[0] = seq[0];
    if (out_pos) out_pos[0] = 0;
    return rle_avx512<PosT>(seq, 1, n, collapse_any, out_chars, out_pos, 1,
                            n);
  }
#endif
  RlePlan plan = rle_plan(seq, n, collapse_any);
  rle_store<PosT>(plan, seq, n, collapse_any, out_chars, out_pos);
  return plan.total;
}

// ---- int64-position (usize-equivalent) throughput --------------------
// The r4-measured 1.0 GB/s median for the int64-position variant at
// 10 MB (BENCH_MODES_r04) was NOT the compress-store's 2x position write
// traffic: with warm output buffers the direct int64 store runs 5.2
// GB/s(in) vs 8.8 for int32 (microbenched), and an int32-staging +
// SIMD-widen variant is SLOWER than the direct store (3.0 GB/s(in) —
// the extra 4B/element scratch round-trip costs more than the narrower
// compress-stores save).  The real residual was allocator behavior: a
// ~63 MB int64 output exceeds glibc's dynamic M_MMAP_THRESHOLD cap
// (32 MB), so every call mmap'd a fresh region and paid ~5 ms of page
// faults, where the ~31 MB int32 output was arena-cached and warm.
// Fix: raise the malloc mmap/trim thresholds once per process so large
// freed output buffers stay warm in the arena (rle_malloc_tune below,
// called from both native entry layers).
inline void rle_malloc_tune() {
#if defined(S2K_HAVE_MALLOC_H) && defined(M_MMAP_THRESHOLD)
  static bool done = [] {
    mallopt(M_MMAP_THRESHOLD, 256 << 20);
    mallopt(M_TRIM_THRESHOLD, 256 << 20);
    return true;
  }();
  (void)done;
#endif
}

// ---- xcode encoding --------------------------------------------------
// out[i] = table[seq[i]] | ((seq[i] != seq[i-1]) << 3): the 3-bit hash
// code plus the precomputed raw-byte-diff HPC keep flag consumed by the
// device stage chain (see constants.py for the format contract; the raw-
// byte run comparison mirrors reference src/nthash_hpc.rs:253-263).

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define S2K_HAVE_AVX512_XCODE 1
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
inline void xcode_avx512(const uint8_t* seq, int64_t n,
                         const uint8_t* table, uint8_t* out) {
  // full 256-entry lookup as two permutex2var halves (low 7 index bits)
  // selected by the byte's high bit.
  const __m512i t0 = _mm512_loadu_si512(table);
  const __m512i t1 = _mm512_loadu_si512(table + 64);
  const __m512i t2 = _mm512_loadu_si512(table + 128);
  const __m512i t3 = _mm512_loadu_si512(table + 192);
  const __m512i eight = _mm512_set1_epi8(8);
  out[0] = table[seq[0]] | 8;
  int64_t i = 1;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512(seq + i);
    __m512i p = _mm512_loadu_si512(seq + i - 1);
    __mmask64 keep = _mm512_cmpneq_epi8_mask(v, p);
    __m512i lo = _mm512_permutex2var_epi8(t0, v, t1);
    __m512i hi = _mm512_permutex2var_epi8(t2, v, t3);
    __m512i code = _mm512_mask_blend_epi8(_mm512_movepi8_mask(v), lo, hi);
    _mm512_storeu_si512(out + i,
                        _mm512_mask_add_epi8(code, keep, code, eight));
  }
  for (; i < n; i++)
    out[i] = table[seq[i]] | ((seq[i] != seq[i - 1]) << 3);
}
#endif

inline void xcode_dispatch(const uint8_t* seq, int64_t n,
                           const uint8_t* table, uint8_t* out) {
  if (n <= 0) return;
#if defined(S2K_HAVE_AVX512_XCODE)
  if (n >= 128 && __builtin_cpu_supports("avx512vbmi")) {
    xcode_avx512(seq, n, table, out);
    return;
  }
#endif
  out[0] = table[seq[0]] | 8;
  for (int64_t i = 1; i < n; i++)
    out[i] = table[seq[i]] | ((seq[i] != seq[i - 1]) << 3);
}

}  // namespace s2k
