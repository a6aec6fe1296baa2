// Host-side data-loading loops of kikuchipy_tpu_torch (a copy of the JAX
// package's native/loader.cpp; the two packages build their own libraries).
//
// The memory-bound inner loops of staging pattern chunks on the host,
// multithreaded over patterns with a C ABI for ctypes:
//
//   kp_u8_to_f32            - uint8 -> float32 bulk conversion
//   kp_preprocess_u8        - uint8 -> float32, static-background
//                             subtract/divide + per-pattern min/max
//                             rescale to [out_min, out_max] (the host
//                             mirror of ops/pattern.py's
//                             remove_static_background used when
//                             staging streamed chunks)
//   kp_reorder_patterns     - gather-reorder of fixed-size records
//                             (Oxford .ebsp out-of-order storage)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see native/__init__.py);
// no dependencies beyond the C++17 standard library.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline unsigned worker_count(int64_t n_items) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    if (n_items < static_cast<int64_t>(hw)) hw = static_cast<unsigned>(n_items > 0 ? n_items : 1);
    return hw;
}

template <typename Fn>
void parallel_for(int64_t n, Fn&& fn) {
    unsigned n_threads = worker_count(n);
    if (n_threads <= 1) {
        for (int64_t i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<int64_t> next(0);
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (unsigned t = 0; t < n_threads; ++t) {
        threads.emplace_back([&]() {
            for (;;) {
                int64_t i = next.fetch_add(1);
                if (i >= n) return;
                fn(i);
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void kp_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
    const int64_t chunk = 1 << 20;
    int64_t n_chunks = (n + chunk - 1) / chunk;
    parallel_for(n_chunks, [&](int64_t c) {
        int64_t lo = c * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        for (int64_t i = lo; i < hi; ++i) dst[i] = static_cast<float>(src[i]);
    });
}

// operation: 0 = subtract, 1 = divide.
void kp_preprocess_u8(const uint8_t* src, const float* bg, float* dst,
                      int64_t n_patterns, int64_t pattern_size,
                      int operation, float out_min, float out_max) {
    parallel_for(n_patterns, [&](int64_t p) {
        const uint8_t* in = src + p * pattern_size;
        float* out = dst + p * pattern_size;
        float mn = 3.4e38f, mx = -3.4e38f;
        if (operation == 0) {
            for (int64_t i = 0; i < pattern_size; ++i) {
                float v = static_cast<float>(in[i]) - bg[i];
                out[i] = v;
                if (v < mn) mn = v;
                if (v > mx) mx = v;
            }
        } else {
            for (int64_t i = 0; i < pattern_size; ++i) {
                float v = static_cast<float>(in[i]) / bg[i];
                out[i] = v;
                if (v < mn) mn = v;
                if (v > mx) mx = v;
            }
        }
        // Per-pattern rescale, same op order as ops/pattern.py
        // (_rescale_with_min_max): (v - mn) / (mx - mn) * range + omin.
        float inv = 1.0f / (mx - mn);
        float range = out_max - out_min;
        for (int64_t i = 0; i < pattern_size; ++i) {
            out[i] = (out[i] - mn) * inv * range + out_min;
        }
    });
}

void kp_reorder_patterns(const uint8_t* src, const int64_t* order,
                         uint8_t* dst, int64_t n_patterns,
                         int64_t bytes_per_pattern) {
    parallel_for(n_patterns, [&](int64_t p) {
        std::memcpy(dst + p * bytes_per_pattern,
                    src + order[p] * bytes_per_pattern,
                    static_cast<size_t>(bytes_per_pattern));
    });
}

}  // extern "C"
