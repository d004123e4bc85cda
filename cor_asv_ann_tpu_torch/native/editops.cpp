// Native edit-distance / alignment kernels (host side).
//
// The reference relies on external C++ for its hot host-side string math
// (rapidfuzz's Levenshtein, SURVEY.md 2.9); this library provides the
// equivalent first-party kernels for this framework:
//  - lev_distance: unweighted codepoint Levenshtein (two-row DP) — the
//    fallback backend of Alignment.get_levenshtein_distance when
//    rapidfuzz is not installed (lib/alignment.py),
//  - nw_align: Needleman-Wunsch alignment emitting a per-symbol pair path
//    with explicit gaps (-1) — an optional exact aligner (Alignment's
//    production path uses difflib for reference parity),
//  - lev_distance_batch: batched distances for evaluation sweeps.
//
// Build: make -C cor_asv_ann_tpu_torch/native  (produces libeditops.so)
// Python binding: ctypes (cor_asv_ann_tpu_torch/lib/native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Unweighted Levenshtein distance over uint32 codepoints.
int lev_distance(const uint32_t* a, int na, const uint32_t* b, int nb) {
    if (na == 0) return nb;
    if (nb == 0) return na;
    std::vector<int> prev(nb + 1), cur(nb + 1);
    for (int j = 0; j <= nb; ++j) prev[j] = j;
    for (int i = 1; i <= na; ++i) {
        cur[0] = i;
        const uint32_t ca = a[i - 1];
        for (int j = 1; j <= nb; ++j) {
            int sub = prev[j - 1] + (ca != b[j - 1] ? 1 : 0);
            int del = prev[j] + 1;
            int ins = cur[j - 1] + 1;
            cur[j] = std::min(sub, std::min(del, ins));
        }
        std::swap(prev, cur);
    }
    return prev[nb];
}

// Batched Levenshtein: sequences concatenated, offsets give boundaries.
void lev_distance_batch(const uint32_t* a, const int* a_off,
                        const uint32_t* b, const int* b_off,
                        int n, int* out) {
    for (int k = 0; k < n; ++k) {
        out[k] = lev_distance(a + a_off[k], a_off[k + 1] - a_off[k],
                              b + b_off[k], b_off[k + 1] - b_off[k]);
    }
}

// Needleman-Wunsch minimal-edit alignment path.
// Writes up to (na+nb) steps into out_src/out_tgt: each step holds the
// source / target index of the aligned pair, or -1 for a gap.
// Returns the number of steps, or -1 if max_steps is too small.
int nw_align(const uint32_t* a, int na, const uint32_t* b, int nb,
             int* out_src, int* out_tgt, int max_steps) {
    if (na + nb > max_steps) return -1;
    // full DP matrix of distances (na+1) x (nb+1); size_t arithmetic —
    // int (na+1)*(nb+1) overflows (UB) already at ~46k x 46k codepoints
    const std::size_t stride = static_cast<std::size_t>(nb) + 1;
    std::vector<int> dp((static_cast<std::size_t>(na) + 1) * stride);
    auto at = [&](int i, int j) -> int& {
        return dp[static_cast<std::size_t>(i) * stride + j];
    };
    for (int i = 0; i <= na; ++i) at(i, 0) = i;
    for (int j = 0; j <= nb; ++j) at(0, j) = j;
    for (int i = 1; i <= na; ++i) {
        const uint32_t ca = a[i - 1];
        for (int j = 1; j <= nb; ++j) {
            int sub = at(i - 1, j - 1) + (ca != b[j - 1] ? 1 : 0);
            int del = at(i - 1, j) + 1;
            int ins = at(i, j - 1) + 1;
            at(i, j) = std::min(sub, std::min(del, ins));
        }
    }
    // traceback (prefer substitution/match, then deletion, then insertion)
    std::vector<int> src, tgt;
    src.reserve(na + nb);
    tgt.reserve(na + nb);
    int i = na, j = nb;
    while (i > 0 || j > 0) {
        if (i > 0 && j > 0 &&
            at(i, j) == at(i - 1, j - 1) + (a[i - 1] != b[j - 1] ? 1 : 0)) {
            src.push_back(i - 1);
            tgt.push_back(j - 1);
            --i; --j;
        } else if (i > 0 && at(i, j) == at(i - 1, j) + 1) {
            src.push_back(i - 1);
            tgt.push_back(-1);
            --i;
        } else {
            src.push_back(-1);
            tgt.push_back(j - 1);
            --j;
        }
    }
    int n = (int)src.size();
    for (int k = 0; k < n; ++k) {
        out_src[k] = src[n - 1 - k];
        out_tgt[k] = tgt[n - 1 - k];
    }
    return n;
}

}  // extern "C"
