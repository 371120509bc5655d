// Native host ops of transformertts_torch, the port's own copy of the JAX
// package's transformertts_tpu/native/csrc/native_ops.cpp.
//
//  - duration_dp_batch: shortest monotonic path through a (mel × phoneme)
//    cost grid (moves: right / down / down-right) + backtrack to integer
//    per-phoneme durations. O(M·N) dynamic program per sample, threaded
//    over the batch by the Python binding. Semantics identical to
//    ops/duration_extraction.py (same DP recurrence, diagonal-preferring
//    tie-breaks).
//  - vad_long_silence_mask: per-window adaptive log-energy voice activity
//    with moving-average smoothing + binary dilation, mirroring
//    audio/vad.py::long_silence_mask (the NumPy path, which
//    trim_long_silences takes where this library is not built).
//
// Built with g++ at first use into build/native/ and bound with ctypes
// (transformertts_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Single-sample DP + backtrack.
//   cost: row-major (m × n) grid costs (already max-attn inverted)
//   durations: out buffer of n int32, will sum to m
void duration_dp(const float* cost, int m, int n, int32_t* durations) {
    std::vector<float> dist((size_t)m * n);
    // row 0: only right-moves
    dist[0] = cost[0];
    for (int j = 1; j < n; ++j) dist[j] = dist[j - 1] + cost[j];
    for (int i = 1; i < m; ++i) {
        const float* crow = cost + (size_t)i * n;
        float* drow = dist.data() + (size_t)i * n;
        const float* prev = dist.data() + (size_t)(i - 1) * n;
        drow[0] = prev[0] + crow[0];
        for (int j = 1; j < n; ++j) {
            float best = std::min(prev[j], std::min(prev[j - 1], drow[j - 1]));
            drow[j] = best + crow[j];
        }
    }
    // backtrack; the first column seen per row while walking backwards is
    // the (forward-order) last column in that row, which owns the row
    std::vector<int32_t> last_col(m, -1);
    int i = m - 1, j = n - 1;
    last_col[i] = j;
    const float INF = std::numeric_limits<float>::infinity();
    while (i > 0 || j > 0) {
        float diag = (i > 0 && j > 0) ? dist[(size_t)(i - 1) * n + j - 1] : INF;
        float up = (i > 0) ? dist[(size_t)(i - 1) * n + j] : INF;
        float left = (j > 0) ? dist[(size_t)i * n + j - 1] : INF;
        if (diag <= up && diag <= left) { --i; --j; }
        else if (up <= left) { --i; }
        else { --j; }
        if (last_col[i] < 0) last_col[i] = j;
    }
    std::memset(durations, 0, sizeof(int32_t) * n);
    for (int r = 0; r < m; ++r) durations[last_col[r]] += 1;
}

// Batched over samples; sequential in C++ — the Python binding parallelizes
// with a thread pool over ``duration_dp_range`` slices (ctypes releases the
// GIL, so host threads scale without native thread management).
// costs: (batch, m_pad, n_pad) row-major; ms/ns give valid dims.
void duration_dp_range(const float* costs, const int32_t* ms,
                       const int32_t* ns, int begin, int end, int m_pad,
                       int n_pad, int32_t* durations_out) {
    for (int b = begin; b < end; ++b) {
        const float* cost = costs + (size_t)b * m_pad * n_pad;
        int m = ms[b], n = ns[b];
        // repack the valid (m, n) region contiguously
        std::vector<float> packed((size_t)m * n);
        for (int i = 0; i < m; ++i)
            std::memcpy(packed.data() + (size_t)i * n,
                        cost + (size_t)i * n_pad, sizeof(float) * n);
        duration_dp(packed.data(), m, n, durations_out + (size_t)b * n_pad);
    }
}

void duration_dp_batch(const float* costs, const int32_t* ms,
                       const int32_t* ns, int batch, int m_pad, int n_pad,
                       int32_t* durations_out) {
    duration_dp_range(costs, ms, ns, 0, batch, m_pad, n_pad, durations_out);
}

// Voice-activity sample mask (audio/vad.py::trim_long_silences semantics).
//   wav: T samples; mask_out: T bytes (0/1) — caller keeps samples with 1.
// Returns the number of windows (mask beyond n_windows*spw is zeroed).
int vad_long_silence_mask(const float* wav, int64_t t, int sampling_rate,
                          int window_ms, int moving_average_width,
                          int max_silence_length, float energy_threshold_db,
                          uint8_t* mask_out) {
    int spw = (window_ms * sampling_rate) / 1000;
    int n_windows = (int)(t / spw);
    std::memset(mask_out, 0, (size_t)t);
    if (n_windows == 0) return 0;

    std::vector<float> rms(n_windows);
    for (int w = 0; w < n_windows; ++w) {
        double acc = 0.0;
        const float* p = wav + (size_t)w * spw;
        for (int s = 0; s < spw; ++s) acc += (double)p[s] * p[s];
        rms[w] = (float)std::sqrt(acc / spw + 1e-12);
    }
    // percentiles with numpy's linear interpolation
    std::vector<float> sorted(rms);
    std::sort(sorted.begin(), sorted.end());
    auto percentile = [&](double q) -> double {
        double pos = q * (n_windows - 1);
        int lo = (int)pos;
        int hi = std::min(lo + 1, n_windows - 1);
        double frac = pos - lo;
        return (1.0 - frac) * sorted[lo] + frac * sorted[hi];
    };
    float ref = (float)percentile(0.95) + 1e-12f;
    // adaptive bimodal threshold (audio/vad.py::adaptive_threshold_db):
    // midpoint between the p10 noise floor and the p95 speech level,
    // clamped to [-48, -12] dB, when the floor is >12 dB below speech;
    // otherwise the conservative fallback gate
    float floor_db =
        20.0f * std::log10((float)(percentile(0.10) + 1e-12) / ref);
    float thr = energy_threshold_db;
    if (floor_db <= -12.0f)
        thr = std::min(-12.0f, std::max(-48.0f, floor_db / 2.0f));
    std::vector<double> db(n_windows);
    for (int w = 0; w < n_windows; ++w)
        db[w] = 20.0 * std::log10((double)rms[w] / ref);
    std::vector<float> flags(n_windows);
    for (int w = 0; w < n_windows; ++w)
        flags[w] = (db[w] > thr) ? 1.0f : 0.0f;

    // --- speech-anchor classification (audio/vad.py module docstring) ---
    // A window anchors speech when it is periodic in the pitch range
    // (normalized autocorr peak over 70-400 Hz lags), syllabically
    // modulated (local dB std over +-8 windows), and audible. Anchors are
    // always speech; anchor-free runs >= 14 windows are never speech.
    // Constants mirror vad.py (_ANCHOR_*, _MOD_CONTEXT, _NONSPEECH_MIN_RUN).
    const int ana = (60 * sampling_rate) / 1000;
    const int lag_lo = (int)(sampling_rate / 400.0);
    const int lag_hi = (int)(sampling_rate / 70.0);
    std::vector<uint8_t> anchor(n_windows, 0);
    bool any_anchor = false;
    std::vector<double> x((size_t)ana);
    for (int w = 0; w < n_windows; ++w) {
        // audibility + modulation first (cheap gates before the autocorr)
        if (db[w] <= -35.0) continue;
        int lo = std::max(0, w - 8), hi = std::min(n_windows, w + 9);
        double mean_db = 0.0;
        for (int k = lo; k < hi; ++k) mean_db += db[k];
        mean_db /= (hi - lo);
        double var = 0.0;
        for (int k = lo; k < hi; ++k)
            var += (db[k] - mean_db) * (db[k] - mean_db);
        if (std::sqrt(var / (hi - lo)) < 2.0) continue;
        // periodicity: centered 60 ms frame, linear autocorr over pitch lags
        int64_t c = (int64_t)w * spw + spw / 2;
        int64_t a = c - ana / 2;
        if (a < 0) a = 0;
        int64_t len = std::min<int64_t>(ana, t - a);
        if (len < lag_hi + 32) continue;
        double mean_x = 0.0;
        for (int64_t s = 0; s < len; ++s) mean_x += wav[a + s];
        mean_x /= (double)len;
        double e = 1e-12;
        for (int64_t s = 0; s < len; ++s) {
            x[(size_t)s] = (double)wav[a + s] - mean_x;
            e += x[(size_t)s] * x[(size_t)s];
        }
        // the anchor decision is a threshold on max(acc)/e, so the lag loop
        // can stop the moment any lag reaches it — exact for the boolean
        const double need = 0.80 * e;
        double best = 0.0;
        for (int tau = lag_lo; tau <= lag_hi; ++tau) {
            double acc = 0.0;
            for (int64_t s = 0; s + tau < len; ++s)
                acc += x[(size_t)s] * x[(size_t)(s + tau)];
            if (acc > best) best = acc;
            if (best >= need) break;
        }
        if (best >= need) {
            anchor[w] = 1;
            any_anchor = true;
        }
    }
    if (any_anchor) {
        for (int w = 0; w < n_windows; ++w)
            if (anchor[w]) flags[w] = 1.0f;
        int i = 0;
        while (i < n_windows) {
            if (anchor[i]) { ++i; continue; }
            int j = i;
            while (j < n_windows && !anchor[j]) ++j;
            if (j - i >= 14)
                for (int w = i; w < j; ++w) flags[w] = 0.0f;
            i = j;
        }
    }

    // centered moving average (matches vad.py::_moving_average padding)
    int width = moving_average_width;
    std::vector<float> avg(n_windows, 0.0f);
    int left = (width - 1) / 2;
    for (int w = 0; w < n_windows; ++w) {
        float acc = 0.0f;
        for (int k = 0; k < width; ++k) {
            int idx = w - left + k;
            if (idx >= 0 && idx < n_windows) acc += flags[idx];
        }
        avg[w] = acc / width;
    }
    // round → binary dilation with flat window (max_silence_length + 1)
    std::vector<uint8_t> bin(n_windows);
    // numpy round-half-even: 0.5 exactly rounds DOWN to 0 on this grid
    for (int w = 0; w < n_windows; ++w)
        bin[w] = (uint8_t)(avg[w] > 0.5f ? 1 : 0);
    int dil = max_silence_length + 1;
    int dleft = dil / 2;  // np.convolve 'same' centering for even widths
    std::vector<uint8_t> dilated(n_windows, 0);
    for (int w = 0; w < n_windows; ++w) {
        for (int k = 0; k < dil; ++k) {
            int idx = w - dleft + k;
            if (idx >= 0 && idx < n_windows && bin[idx]) {
                dilated[w] = 1;
                break;
            }
        }
    }
    for (int w = 0; w < n_windows; ++w)
        if (dilated[w])
            std::memset(mask_out + (size_t)w * spw, 1, spw);
    return n_windows;
}

}  // extern "C"
