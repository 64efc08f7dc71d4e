// Fast N-dimensional histogram accumulation for template building.
//
// This is the host-side hot loop of the framework: every MonteCarloSource /
// DensityEstimatingSource template build histograms millions of events into
// the analysis-space bins (once per anchor model — 81x for a XENON1T-style
// morphing grid). numpy.histogramdd pays for generality (digitize + ravel +
// bincount passes with large temporaries); this kernel does one cache-friendly
// pass with per-axis binary search (and a multiply fast path for uniform
// edges), matching numpy.histogramdd semantics exactly: left-edge inclusive,
// last bin right-inclusive, out-of-range events dropped, NaNs dropped.
//
// Exposed via ctypes (no pybind11 in this environment); see __init__.py.

#include <cmath>
#include <cstdint>

namespace {

struct Axis {
    const double* edges;
    int64_t n_edges;        // number of edges (bins = n_edges - 1)
    int64_t stride;         // row-major stride of this axis in the output
    bool uniform;
    double lo, hi, inv_width;
};

// Bin index via the uniform fast path or binary search; -1 if out of range.
inline int64_t bin_index(const Axis& ax, double x) {
    if (!(x >= ax.lo && x <= ax.hi))    // also rejects NaN
        return -1;
    const int64_t n_bins = ax.n_edges - 1;
    if (n_bins <= 0)
        // Degenerate single-edge axis: no bins. Without this guard the
        // uniform path computes (x-lo)*inv_width = 0*inf/NaN and casting
        // NaN to int64 is undefined behavior.
        return -1;
    if (ax.uniform) {
        int64_t i = (int64_t)((x - ax.lo) * ax.inv_width);
        if (i >= n_bins) i = n_bins - 1;          // right edge of last bin
        // Guard against rounding at interior edges: emulate histogramdd's
        // left-inclusive convention exactly
        while (i > 0 && x < ax.edges[i]) --i;
        while (i < n_bins - 1 && x >= ax.edges[i + 1]) ++i;
        return i;
    }
    // binary search: greatest i with edges[i] <= x  (last bin right-incl.)
    int64_t lo = 0, hi = ax.n_edges - 1;
    while (hi - lo > 1) {
        int64_t mid = (lo + hi) / 2;
        if (x >= ax.edges[mid]) lo = mid; else hi = mid;
    }
    if (lo == n_bins) --lo;                        // x exactly at last edge
    return lo;
}

}  // namespace

extern "C" {

// coords: (n_events, ndim) C-contiguous float64
// edges_flat / edge_offsets: concatenated per-axis edge arrays
// weights: optional (nullptr -> weight 1)
// out: flattened row-major bin counts, pre-zeroed by the caller
void hist_nd(const double* coords, int64_t n_events, int32_t ndim,
             const double* edges_flat, const int64_t* edge_offsets,
             const uint8_t* uniform_flags,
             const double* weights, double* out) {
    Axis axes[16];
    int64_t stride = 1;
    for (int d = ndim - 1; d >= 0; --d) {
        Axis& ax = axes[d];
        ax.edges = edges_flat + edge_offsets[d];
        ax.n_edges = edge_offsets[d + 1] - edge_offsets[d];
        ax.stride = stride;
        stride *= (ax.n_edges - 1);
        ax.uniform = uniform_flags[d] != 0;
        ax.lo = ax.edges[0];
        ax.hi = ax.edges[ax.n_edges - 1];
        ax.inv_width = (ax.n_edges - 1) / (ax.hi - ax.lo);
    }

    for (int64_t e = 0; e < n_events; ++e) {
        const double* row = coords + (int64_t)e * ndim;
        int64_t flat = 0;
        bool ok = true;
        for (int d = 0; d < ndim; ++d) {
            int64_t i = bin_index(axes[d], row[d]);
            if (i < 0) { ok = false; break; }
            flat += i * axes[d].stride;
        }
        if (ok)
            out[flat] += weights ? weights[e] : 1.0;
    }
}

int32_t fasthist_abi_version() { return 1; }

}  // extern "C"
