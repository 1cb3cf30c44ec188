// faiss_tpu_torch native runtime — host-side C++ core.
//
// The port's own copy of faiss_tpu/native/src/faiss_tpu_native.cpp: the same
// C API, the same arithmetic and the same ft_version. The port cannot load
// faiss_tpu's library (importing faiss_tpu.native imports jax), so it builds
// this file itself (see native/__init__.py).
//
// Host equivalents of the reference's native components:
//   * ft_alloc_aligned / ft_free_aligned  ≈ alloc_aligned/free_aligned
//     (include/faiss-metal/MetalResources.h:20-33): page-aligned staging
//     buffers for host→device copies.
//   * ft_f32_to_bf16 / ft_f32_to_f16      ≈ the host round-to-nearest-even
//     conversion loops in MetalIndexFlat::add (src/MetalIndexFlat.mm:226-256),
//     which parallelize with GCD dispatch_apply for >100K elements. Here:
//     std::thread chunking. Converting on the host before the upload halves
//     host→device transfer bytes for reduced-precision storage.
//   * ft_l2_norms_f32                     ≈ MetalL2Norm's role at add() time
//     (norms MUST come from the fp32 input before quantization —
//     src/MetalIndexFlat.mm:258-267) for host-staged ingestion pipelines.
//   * ft_merge_topk_f32                   ≈ block_select's pairwise k-list
//     merge (shaders/block_select.metal:49-79) — but keeping the full k
//     (the reference keeps only 8, SURVEY.md §2.3.1). A two-pointer merge:
//     it assumes both lists sorted best-first (faiss_tpu_torch.multi keeps
//     a stable merge for that reason).
//   * ft_fill_sentinels                   ≈ the search copy-out sentinel fill
//     (src/MetalIndexFlat.mm:384-400).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread -march=native
// (see native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif
#include <unistd.h>

// ---------------------------------------------------------------------------
// helpers (C++ linkage)
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t kParallelThreshold = 100000;  // match reference's >100K gate

template <typename Fn>
void parallel_chunks(int64_t n, int nthreads, Fn fn) {
    if (nthreads <= 1 || n < kParallelThreshold) {
        fn((int64_t)0, n);
        return;
    }
    int hw = (int)std::thread::hardware_concurrency();
    if (hw > 0 && nthreads > hw) nthreads = hw;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    std::vector<std::thread> ts;
    ts.reserve((size_t)nthreads);
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        if (lo >= n) break;
        int64_t hi = std::min(n, lo + chunk);
        ts.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

inline uint16_t bf16_rne(uint32_t x) {
    // NaN: keep quiet NaN (set a mantissa bit so it doesn't become inf)
    if ((x & 0x7FFFFFFFu) > 0x7F800000u) {
        return (uint16_t)((x >> 16) | 0x0040u);
    }
    uint32_t bias = 0x7FFFu + ((x >> 16) & 1u);
    return (uint16_t)((x + bias) >> 16);
}

inline uint16_t f16_rne(uint32_t x) {
    uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t mant = x & 0x7FFFFFu;
    int32_t exp = (int32_t)((x >> 23) & 0xFFu);
    if (exp == 0xFF) {  // inf / nan
        return (uint16_t)(sign | 0x7C00u |
                          (mant ? (0x200u | (mant >> 13)) : 0u));
    }
    int32_t e = exp - 127 + 15;
    if (e >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow → inf
    if (e <= 0) {
        if (e < -10) return (uint16_t)sign;            // underflow → ±0
        mant |= 0x800000u;                              // implicit leading 1
        uint32_t shift = (uint32_t)(14 - e);            // 14..24
        uint32_t half = mant >> shift;
        uint32_t rem = mant & ((1u << shift) - 1u);
        uint32_t halfway = 1u << (shift - 1u);
        if (rem > halfway || (rem == halfway && (half & 1u))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = ((uint32_t)e << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFFu;
    // RNE; a carry out of the mantissa correctly bumps the exponent
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
    return (uint16_t)(sign | half);
}

}  // namespace

// ---------------------------------------------------------------------------
// exported C API
// ---------------------------------------------------------------------------

extern "C" {

void* ft_alloc_aligned(size_t bytes) {
    size_t page = (size_t)sysconf(_SC_PAGESIZE);
    size_t aligned = (bytes + page - 1) & ~(page - 1);
    void* ptr = nullptr;
    if (posix_memalign(&ptr, page, aligned ? aligned : page) != 0) {
        return nullptr;
    }
    return ptr;
}

void ft_free_aligned(void* ptr) { free(ptr); }

void ft_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                    int nthreads) {
    parallel_chunks(n, nthreads, [&](int64_t lo, int64_t hi) {
        const uint32_t* s = (const uint32_t*)src;
        for (int64_t i = lo; i < hi; ++i) dst[i] = bf16_rne(s[i]);
    });
}

void ft_f32_to_f16(const float* src, uint16_t* dst, int64_t n, int nthreads) {
    parallel_chunks(n, nthreads, [&](int64_t lo, int64_t hi) {
        const uint32_t* s = (const uint32_t*)src;
        for (int64_t i = lo; i < hi; ++i) dst[i] = f16_rne(s[i]);
    });
}

// row-wise ‖v‖² of an (n, d) fp32 matrix, double accumulation per row
void ft_l2_norms_f32(const float* src, float* dst, int64_t n, int64_t d,
                     int nthreads) {
    parallel_chunks(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const float* row = src + i * d;
            double acc = 0.0;
            for (int64_t j = 0; j < d; ++j) {
                acc += (double)row[j] * (double)row[j];
            }
            dst[i] = (float)acc;
        }
    });
}

// Merge two per-row k-lists sorted best-first into `out` (k entries/row).
// `largest` != 0 → higher value is better (scores); 0 → lower is better
// (distances). Ties prefer list A, then lower index — matching lax.top_k
// over a concatenated [A|B] array.
void ft_merge_topk_f32(const float* va, const int64_t* ia, int64_t ka,
                       const float* vb, const int64_t* ib, int64_t kb,
                       float* vo, int64_t* io, int64_t k, int64_t nq,
                       int largest, int nthreads) {
    parallel_chunks(nq, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            const float* a = va + r * ka;
            const int64_t* aid = ia + r * ka;
            const float* b = vb + r * kb;
            const int64_t* bid = ib + r * kb;
            float* ov = vo + r * k;
            int64_t* oi = io + r * k;
            int64_t i = 0, j = 0;
            for (int64_t o = 0; o < k; ++o) {
                bool take_a;
                if (i >= ka) {
                    take_a = false;
                } else if (j >= kb) {
                    take_a = true;
                } else if (largest) {
                    take_a = a[i] >= b[j];
                } else {
                    take_a = a[i] <= b[j];
                }
                if (take_a) {
                    ov[o] = a[i];
                    oi[o] = aid[i];
                    ++i;
                } else {
                    ov[o] = b[j];
                    oi[o] = bid[j];
                    ++j;
                }
            }
        }
    });
}

// Fill ranks [k_eff, k) with sentinel distance/label per row.
void ft_fill_sentinels(float* dists, int64_t* labels, int64_t nq, int64_t k,
                       int64_t k_eff, float sentinel_dist,
                       int64_t sentinel_label) {
    for (int64_t r = 0; r < nq; ++r) {
        float* dv = dists + r * k;
        int64_t* lv = labels + r * k;
        for (int64_t o = k_eff; o < k; ++o) {
            dv[o] = sentinel_dist;
            lv[o] = sentinel_label;
        }
    }
}

int ft_version() { return 1; }

}  // extern "C"
