// Native host components: the corpus packer (ragged strings -> padded
// fixed-width unit matrices), the batched host match pipelines for the rows
// the device does not finish (greedy windows, XL rows), the batched literal
// matcher and the batched alignment traceback.
//
// The NumPy packer (corpus.py) spends its time in fancy-indexing scatters;
// this is a single linear pass with memcpy, parallelized over rows with
// OpenMP. Loaded via ctypes (no Python C API: inputs are plain buffers
// prepared by the Python side — a joined byte/UTF-32 buffer plus offset
// tables); ctypes releases the GIL for the length of each call.
//
// Semantics contract: frizbee_tpu_torch/corpus.py pack_corpus (its NumPy
// twin, reached through native._FORCE_NUMPY, is the differential oracle;
// tests assert byte-identical outputs).

#include <cstdint>
#include <cstring>
#include <vector>
#include <omp.h>

extern "C" {

// ASCII/bytes path: copy each selected row's bytes into a zero-padded
// (nrows, width) int8 matrix.
void pack_rows_u8(const uint8_t* joined, const int64_t* starts,
                  const int64_t* rows, int64_t nrows, int64_t width,
                  int8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; ++r) {
        int64_t row = rows[r];
        int8_t* dst = out + r * width;
        if (row < 0) {  // size-class padding row
            std::memset(dst, 0, (size_t)width);
            continue;
        }
        int64_t s = starts[row];
        int64_t len = starts[row + 1] - s;
        if (len > width) len = width;
        std::memcpy(dst, joined + s, (size_t)len);
        if (len < width) std::memset(dst + len, 0, (size_t)(width - len));
    }
}

// Unicode path: units are codepoints (from a UTF-32LE buffer), emitted as
// one zero-padded (nrows, width) int32 matrix. The UTF-8 context of each
// unit (first byte, previous unit's last byte, byte offset, byte length)
// derives from the codepoints on the host where the traceback needs it
// (PackedBucket._full_arrays), so it is not packed here.
void pack_rows_u32(const uint32_t* joined, const int64_t* starts,
                   const int64_t* rows, int64_t nrows, int64_t width,
                   int32_t* cp) {
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < nrows; ++r) {
        int64_t row = rows[r];
        int32_t* dst = cp + r * width;
        int64_t len = 0;
        if (row >= 0) {  // row < 0: size-class padding, emit empty
            int64_t s = starts[row];
            len = starts[row + 1] - s;
            if (len > width) len = width;
            std::memcpy(dst, joined + s, (size_t)len * sizeof(int32_t));
        }
        if (len < width)
            std::memset(dst + len, 0, (size_t)(width - len) * sizeof(int32_t));
    }
}

// Batched alignment traceback: per-row scalar DP fill + walk over the
// packed bucket arrays, parallelized over rows. ~10M DP cells for a
// 10k-match result set, so native scalar code beats NumPy vectorization
// by an order of magnitude here (the walk is branchy and the matrices
// are small). Semantics contract: frizbee_tpu_torch/oracle/smith_waterman.py
// sw_matrices + sw_indices (reference: src/smith_waterman/algo/ascii.rs
// recurrence, src/smith_waterman/alignment_iter.rs:112-181 walk); the
// NumPy twin in frizbee_tpu_torch/traceback.py (its _FORCE_NUMPY branch)
// stays as the differential oracle. int32 with clamp-at-zero equals the
// reference's u16 saturating chain for guard-passing configs (see
// traceback.py module doc).
//
// Inputs are (R, W) bucket arrays; [su, eu) is each row's prefilter
// window in unit coordinates (window bytes already trimmed by start-1).
// Outputs: score, reversed matched byte offsets (cap = 4*n per row).
void sw_indices_batch(const int32_t* cp, const int32_t* first,
                      const int32_t* prev, const int32_t* boff,
                      const int32_t* blen, const int32_t* su,
                      const int32_t* eu, const uint8_t* inc_prefix,
                      int64_t R, int64_t W, const int32_t* orig,
                      const int32_t* flip, int64_t n,
                      const int32_t* scoring, int64_t max_typos,
                      int32_t* score_out, int32_t* cnt_out,
                      int32_t* idx_out, int64_t cap) {
    const int32_t ms = scoring[0], mm_pen = scoring[1];
    const int32_t gap_open = scoring[2], gap_ext = scoring[3];
    const int32_t prefix_b = scoring[4], cap_b = scoring[5];
    const int32_t case_b = scoring[6], delim_b = scoring[8];
    const int32_t goe = gap_open > gap_ext ? gap_open - gap_ext : 0;

#pragma omp parallel
    {
        // per-thread (n+1) x (m+1) score + match-mask matrices
        std::vector<int32_t> H((size_t)(n + 1) * (W + 1));
        std::vector<uint8_t> MM((size_t)(n + 1) * (W + 1));
        std::vector<int32_t> bonus((size_t)W);

#pragma omp for schedule(dynamic, 16)
        for (int64_t r = 0; r < R; ++r) {
            const int64_t base = r * W;
            const int32_t s0 = su[r];
            const int64_t m = (int64_t)eu[r] - s0;
            score_out[r] = 0;
            cnt_out[r] = 0;
            if (m <= 0 || n == 0) continue;
            const int64_t stride = m + 1;

            for (int64_t j = 0; j < m; ++j) {
                int32_t fb = first[base + s0 + j];
                int32_t pb = j == 0 ? -1 : prev[base + s0 + j];
                bool fu = fb >= 0x41 && fb <= 0x5A;
                bool pl = pb >= 0x61 && pb <= 0x7A;
                auto is_delim = [](int32_t b) {
                    bool letter = (b >= 0x41 && b <= 0x5A) ||
                                  (b >= 0x61 && b <= 0x7A);
                    bool digit = b >= 0x30 && b <= 0x39;
                    return b >= 0 && b <= 127 && !letter && !digit;
                };
                int32_t bo = 0;
                if (fu && pl) bo += cap_b;
                if (is_delim(pb) && !is_delim(fb)) bo += delim_b;
                if (inc_prefix[r] && j == 0) bo += prefix_b;
                bonus[(size_t)j] = bo;
            }

            for (int64_t j = 0; j <= m; ++j) {
                H[(size_t)j] = 0;
                MM[(size_t)j] = 0;
            }
            for (int64_t i = 1; i <= n; ++i) {
                const int32_t no = orig[i - 1], nf = flip[i - 1];
                int32_t* row = H.data() + (size_t)(i * stride);
                const int32_t* prow = H.data() + (size_t)((i - 1) * stride);
                uint8_t* mrow = MM.data() + (size_t)(i * stride);
                const uint8_t* pmm = MM.data() + (size_t)((i - 1) * stride);
                row[0] = 0;
                mrow[0] = 0;
                for (int64_t j = 1; j <= m; ++j) {
                    const int32_t h = cp[base + s0 + j - 1];
                    const bool exact = h == no;
                    const bool match = exact || h == nf;
                    mrow[j] = match;
                    int32_t diag = prow[j - 1];
                    if (match) diag += ms + mm_pen + bonus[(size_t)(j - 1)];
                    diag -= mm_pen;
                    if (diag < 0) diag = 0;
                    if (exact) diag += case_b;
                    int32_t up =
                        prow[j] - gap_ext - (pmm[j] ? goe : 0);
                    if (up < 0) up = 0;
                    int32_t left =
                        row[j - 1] - gap_ext - (mrow[j - 1] ? goe : 0);
                    if (left < 0) left = 0;
                    int32_t v = diag > up ? diag : up;
                    row[j] = v > left ? v : left;
                }
            }

            const int32_t* fin = H.data() + (size_t)(n * stride);
            int32_t score = 0;
            for (int64_t j = 1; j <= m; ++j)
                if (fin[j] > score) score = fin[j];
            score_out[r] = score;
            if (score == 0) continue;

            int64_t col = 1;
            while (fin[col] != score) ++col;
            int64_t row_i = n;
            int32_t cur = score;
            int64_t typo = 0;
            int32_t cnt = 0;
            int32_t* out = idx_out + r * cap;
            while (row_i > 0) {
                if (max_typos >= 0 && typo > max_typos) break;
                if (col < 1 || cur == 0) break;
                if (MM[(size_t)(row_i * stride + col)]) {
                    const int64_t unit = s0 + col - 1;
                    const int32_t off = boff[base + unit];
                    // defensive ABI bound (callers pass cap = 4*n, which a
                    // <=4-byte unit per needle row can't exceed, but the
                    // guard keeps a future caller from a heap overflow)
                    for (int32_t b = blen[base + unit] - 1;
                         b >= 0 && cnt < cap; --b)
                        out[cnt++] = off + b;
                    --row_i;
                    --col;
                    cur = H[(size_t)(row_i * stride + col)];
                    continue;
                }
                const int32_t diag =
                    H[(size_t)((row_i - 1) * stride + col - 1)];
                const int32_t left = H[(size_t)(row_i * stride + col - 1)];
                const int32_t up = H[(size_t)((row_i - 1) * stride + col)];
                if (diag >= left && diag >= up) {
                    --row_i;
                    --col;
                    ++typo;
                    cur = diag;
                } else if (left >= up) {
                    --col;
                    cur = left;
                } else {
                    --row_i;
                    ++typo;
                    cur = up;
                }
            }
            cnt_out[r] = cnt;
        }
    }
}

// ---------------------------------------------------------------------
// Batched ASCII host pipeline for rows the device can't score in-bucket:
// greedy rows (trimmed window beyond the DP cap) and XL rows (longer
// than the widest bucket). Byte-unit engines here, codepoint-unit engines
// in host_match_batch_u32 below; the per-row Python pipeline stays the
// differential twin (native._FORCE_NUMPY). Semantics contract, ported
// line for line in saturating u16 arithmetic:
//   frizbee_tpu_torch/engine.py _host_pipeline
//   -> oracle/prefilter.py prefilter_window   (typo minimal-position DP)
//   -> oracle/greedy.py match_greedy          (window > dp_cap)
//   -> oracle/smith_waterman.py sw_matrices + match_end_col (otherwise)
// (reference: src/matcher/algo.rs pipeline, src/smith_waterman/greedy.rs)

static inline int32_t sat_add16(int32_t a, int32_t b) {
    int32_t v = a + b;
    return v > 0xFFFF ? 0xFFFF : v;
}
static inline int32_t sat_sub16(int32_t a, int32_t b) {
    int32_t v = a - b;
    return v < 0 ? 0 : v;
}
static inline int32_t sat_mul16(int64_t a, int64_t b) {
    int64_t v = a * b;
    return v > 0xFFFF ? 0xFFFF : (int32_t)v;
}
static inline bool is_delim_b(int32_t b) {
    bool letter = (b >= 0x41 && b <= 0x5A) || (b >= 0x61 && b <= 0x7A);
    bool digit = b >= 0x30 && b <= 0x39;
    return b >= 0 && b <= 127 && !letter && !digit;
}

// Traceback walk over a filled (n+1)x(m+1) score/match-mask matrix pair:
// first final-row column holding the max, diag on match, else
// max(diag, left, up); Mismatch/Up moves spend the typo budget and the
// walk truncates when it is exceeded (score kept, indices cut) —
// semantics contract: oracle/smith_waterman.sw_indices, identical to
// sw_indices_batch's walk. Matched units emit their byte offsets in
// reverse order: per-unit (uoff, ulen) arrays over the window when
// given, else ASCII bytes at wstart + unit. Returns the count written.
static int32_t walk_indices(const int32_t* H, const uint8_t* MM, int64_t n,
                            int64_t m, int32_t score, int64_t max_typos,
                            const int32_t* uoff, const int32_t* ulen,
                            int64_t wstart, int32_t* out, int64_t icap) {
    const int64_t stride = m + 1;
    const int32_t* fin = H + (size_t)(n * stride);
    int64_t col = 1;
    while (fin[col] != score) ++col;
    int64_t row_i = n;
    int32_t cur = score;
    int64_t typo = 0;
    int32_t cnt = 0;
    while (row_i > 0) {
        if (max_typos >= 0 && typo > max_typos) break;
        if (col < 1 || cur == 0) break;
        if (MM[(size_t)(row_i * stride + col)]) {
            const int64_t unit = col - 1;
            if (uoff) {
                const int32_t off = uoff[(size_t)unit];
                for (int32_t b = ulen[(size_t)unit] - 1;
                     b >= 0 && cnt < icap; --b)
                    out[cnt++] = off + b;
            } else if (cnt < icap) {
                out[cnt++] = (int32_t)(wstart + unit);
            }
            --row_i;
            --col;
            cur = H[(size_t)(row_i * stride + col)];
            continue;
        }
        const int32_t diag = H[(size_t)((row_i - 1) * stride + col - 1)];
        const int32_t left = H[(size_t)(row_i * stride + col - 1)];
        const int32_t up = H[(size_t)((row_i - 1) * stride + col)];
        if (diag >= left && diag >= up) {
            --row_i;
            --col;
            ++typo;
            cur = diag;
        } else if (left >= up) {
            --col;
            cur = left;
        } else {
            --row_i;
            ++typo;
            cur = up;
        }
    }
    return cnt;
}

// ``rows``: optional selection — result slot r scores row rows[r] of the
// ragged buffer (null = identity), so callers with a resident encoded
// blob (e.g. the corpus's XL rows) select per-query candidate subsets
// without re-encoding anything.
// ``idx_out``/``icnt_out`` (optional, with per-row capacity ``icap``):
// matched byte offsets in reverse order, the MatchIndices contract —
// greedy matches recorded in-scan, SW matches via a full-matrix
// traceback walk (engine.match_one_indices is the per-row oracle).
void host_match_batch(const uint8_t* joined, const int64_t* starts,
                      const int64_t* rows,
                      int64_t R,
                      const int32_t* orig, const int32_t* flip, int64_t n,
                      const int32_t* scoring, int64_t max_typos,
                      int64_t dp_cap, int64_t min_len,
                      const uint8_t* needle_bytes, int64_t needle_len,
                      uint8_t* matched_out, int32_t* score_out,
                      uint8_t* exact_out, int32_t* end_col_out,
                      int32_t* idx_out, int32_t* icnt_out, int64_t icap) {
    const int32_t ms = scoring[0], mm_pen = scoring[1];
    const int32_t gap_open = scoring[2], gap_ext = scoring[3];
    const int32_t prefix_b = scoring[4], cap_b = scoring[5];
    const int32_t case_b = scoring[6], exact_b = scoring[7];
    const int32_t delim_b = scoring[8];
    const int32_t goe = sat_sub16(gap_open, gap_ext);
    const int64_t T = max_typos;  // -1 = no prefilter
    const bool want_idx = idx_out != nullptr;

#pragma omp parallel
    {
        // rolling SW rows + match masks + per-window bonuses (window
        // length is <= dp_cap on the SW branch); full matrices only for
        // the traceback variant
        std::vector<int32_t> h0((size_t)dp_cap + 1), h1((size_t)dp_cap + 1);
        std::vector<uint8_t> m0((size_t)dp_cap + 1), m1((size_t)dp_cap + 1);
        std::vector<int32_t> bonus((size_t)dp_cap);
        std::vector<int64_t> f, nf;  // typo DP states
        std::vector<int32_t> Hf;
        std::vector<uint8_t> Mf;
        std::vector<int64_t> gidx;  // greedy matched positions (<= n)
        if (want_idx) {
            Hf.resize((size_t)(n + 1) * (dp_cap + 1));
            Mf.resize((size_t)(n + 1) * (dp_cap + 1));
            gidx.reserve((size_t)n);
        }

#pragma omp for schedule(dynamic, 8)
        for (int64_t r = 0; r < R; ++r) {
            matched_out[r] = 0;
            score_out[r] = 0;
            exact_out[r] = 0;
            end_col_out[r] = 0;
            if (want_idx) icnt_out[r] = 0;
            const int64_t src = rows ? rows[r] : r;
            const uint8_t* hay = joined + starts[src];
            const int64_t len = starts[src + 1] - starts[src];
            if (len < min_len) continue;

            // -- prefilter window (byte units: byte_off[j] == j) --------
            int64_t start = 0, end = len;
            if (T >= 0) {
                if (n <= T) {
                    // a needle no longer than the budget always matches
                } else if (len == 0) {
                    continue;
                } else if (T == 0) {
                    // greedy leftmost embedding
                    int64_t pos = -1, first_pos = -1;
                    bool ok = true;
                    for (int64_t k = 0; k < n; ++k) {
                        int64_t nxt = -1;
                        for (int64_t j = pos + 1; j < len; ++j) {
                            if (hay[j] == orig[k] || hay[j] == flip[k]) {
                                nxt = j;
                                break;
                            }
                        }
                        if (nxt < 0) { ok = false; break; }
                        if (first_pos < 0) first_pos = nxt;
                        pos = nxt;
                    }
                    if (!ok) continue;
                    // end: last occurrence of the final needle unit at or
                    // after the greedy completion position
                    int64_t end_unit = pos;
                    for (int64_t j = len - 1; j >= pos; --j) {
                        if (hay[j] == orig[n - 1] || hay[j] == flip[n - 1]) {
                            end_unit = j;
                            break;
                        }
                    }
                    start = first_pos;
                    end = end_unit + 1;
                } else {
                    // exact minimal-position DP over the typo budget
                    const int64_t INF = INT64_MAX / 2;
                    f.assign((size_t)T + 1, 0);
                    nf.assign((size_t)T + 1, 0);
                    for (int64_t k = 0; k < n; ++k) {
                        for (int64_t t = 0; t <= T; ++t) {
                            int64_t v = INF;
                            if (f[(size_t)t] < INF) {
                                for (int64_t j = f[(size_t)t]; j < len; ++j) {
                                    if (hay[j] == orig[k] ||
                                        hay[j] == flip[k]) {
                                        v = j + 1;
                                        break;
                                    }
                                }
                            }
                            if (t > 0 && f[(size_t)(t - 1)] < v)
                                v = f[(size_t)(t - 1)];
                            nf[(size_t)t] = v;
                        }
                        f.swap(nf);
                    }
                    if (f[(size_t)T] >= INF) continue;
                    // start: min first occurrence among needle[0..=T]
                    const int64_t kmax = T + 1 < n ? T + 1 : n;
                    for (int64_t j = 0; j < len; ++j) {
                        bool any = false;
                        for (int64_t k = 0; k < kmax; ++k)
                            if (hay[j] == orig[k] || hay[j] == flip[k]) {
                                any = true;
                                break;
                            }
                        if (any) { start = j; break; }
                    }
                    // end: last occurrence of any of the last T+1 units
                    const int64_t first_tail = n - 1 - T;
                    for (int64_t j = len - 1; j >= 0; --j) {
                        bool any = false;
                        for (int64_t k = first_tail; k < n; ++k)
                            if (hay[j] == orig[k] || hay[j] == flip[k]) {
                                any = true;
                                break;
                            }
                        if (any) { end = j + 1; break; }
                    }
                }
            }

            const int64_t wstart = start > 0 ? start - 1 : 0;
            const bool include_exact = wstart == 0 && end == len;
            const bool include_prefix = wstart == 0;
            const uint8_t* win = hay + wstart;
            const int64_t m = end - wstart;
            matched_out[r] = 1;
            const bool is_exact =
                include_exact && m == needle_len &&
                std::memcmp(win, needle_bytes, (size_t)needle_len) == 0;

            if (m > dp_cap) {
                // -- greedy fallback (oracle/greedy.py match_greedy) ----
                if (n > m) {  // len(pairs) > len(haystack): no match
                    end_col_out[r] =
                        wstart > 0xFFFF ? 0xFFFF : (int32_t)wstart;
                    continue;
                }
                int32_t score = 0;
                int64_t hi = 0;
                int64_t last_idx = 0;
                bool deb = false;       // delimiter_bonus_enabled
                bool prev_lower = false;
                bool prev_delim = false;
                bool ok = true;
                if (want_idx) gidx.clear();
                for (int64_t k = 0; k < n; ++k) {
                    const int64_t hstart = hi;
                    const int64_t limit = m - n + k;
                    bool found = false;
                    while (hi <= limit) {
                        const int32_t h = win[hi];
                        const bool h_digit = h >= 0x30 && h <= 0x39;
                        const bool h_upper = h >= 0x41 && h <= 0x5A;
                        const bool h_lower = h >= 0x61 && h <= 0x7A;
                        const bool h_delim =
                            h <= 127 && !(h_lower || h_upper || h_digit);
                        if (!h_delim) deb = true;
                        if (h != orig[k] && h != flip[k]) {
                            prev_delim = deb && h_delim;
                            prev_lower = h_lower;
                            ++hi;
                            continue;
                        }
                        score = sat_add16(score, ms);
                        if (hi != hstart && k != 0) {
                            int64_t gap = hi - hstart - 1;
                            if (gap < 0) gap = 0;
                            if (gap > 0xFFFF) gap = 0xFFFF;
                            score = sat_sub16(
                                score,
                                sat_add16(gap_open,
                                          sat_mul16(gap_ext, gap)));
                        }
                        if (h == orig[k]) score = sat_add16(score, case_b);
                        if (h_upper && prev_lower)
                            score = sat_add16(score, cap_b);
                        if (include_prefix && hi == 0)
                            score = sat_add16(score, prefix_b);
                        if (prev_delim && !h_delim)
                            score = sat_add16(score, delim_b);
                        prev_delim = deb && h_delim;
                        prev_lower = h_lower;
                        last_idx = hi;
                        if (want_idx) gidx.push_back(hi);
                        ++hi;
                        found = true;
                        break;
                    }
                    if (!found) { ok = false; break; }
                }
                if (!ok) {
                    end_col_out[r] =
                        wstart > 0xFFFF ? 0xFFFF : (int32_t)wstart;
                    continue;
                }
                int64_t ec = last_idx > 0xFFFF ? 0xFFFF : last_idx;
                ec += wstart;
                if (ec > 0xFFFF) ec = 0xFFFF;
                if (is_exact) score = sat_add16(score, exact_b);
                score_out[r] = score;
                exact_out[r] = is_exact;
                end_col_out[r] = (int32_t)ec;
                if (want_idx) {
                    int32_t* out = idx_out + r * icap;
                    int32_t cnt = 0;
                    for (int64_t g = (int64_t)gidx.size() - 1;
                         g >= 0 && cnt < icap; --g)
                        out[cnt++] = (int32_t)(gidx[(size_t)g] + wstart);
                    icnt_out[r] = cnt;
                }
                continue;
            }

            // -- full SW over the window (oracle sw_matrices) -----------
            for (int64_t j = 0; j < m; ++j) {
                const int32_t fb = win[j];
                const int32_t pb = j == 0 ? -1 : win[j - 1];
                int32_t bo = 0;
                if (fb >= 0x41 && fb <= 0x5A && pb >= 0x61 && pb <= 0x7A)
                    bo += cap_b;
                if (is_delim_b(pb) && !is_delim_b(fb)) bo += delim_b;
                if (include_prefix && j == 0) bo += prefix_b;
                bonus[(size_t)j] = bo;
            }
            const int64_t stride = m + 1;
            int32_t* prow = h0.data();
            int32_t* row = h1.data();
            uint8_t* pmm = m0.data();
            uint8_t* mrow = m1.data();
            if (want_idx) {
                prow = Hf.data();
                pmm = Mf.data();
            }
            for (int64_t j = 0; j <= m; ++j) {
                prow[j] = 0;
                pmm[j] = 0;
            }
            for (int64_t i = 1; i <= n; ++i) {
                const int32_t no = orig[i - 1], nfl = flip[i - 1];
                if (want_idx) {
                    row = Hf.data() + (size_t)(i * stride);
                    mrow = Mf.data() + (size_t)(i * stride);
                }
                row[0] = 0;
                mrow[0] = 0;
                for (int64_t j = 1; j <= m; ++j) {
                    const int32_t h = win[j - 1];
                    const bool exact_c = h == no;
                    const bool match = exact_c || h == nfl;
                    mrow[j] = match;
                    int32_t diag = prow[j - 1];
                    if (match)
                        diag = sat_add16(
                            diag, ms + mm_pen + bonus[(size_t)(j - 1)]);
                    diag = sat_sub16(diag, mm_pen);
                    if (exact_c) diag = sat_add16(diag, case_b);
                    int32_t up = sat_sub16(prow[j], gap_ext);
                    if (pmm[j]) up = sat_sub16(up, goe);
                    int32_t left = sat_sub16(
                        row[j - 1], gap_ext + (mrow[j - 1] ? goe : 0));
                    int32_t v = diag > up ? diag : up;
                    row[j] = v > left ? v : left;
                }
                if (want_idx) {
                    prow = row;
                    pmm = mrow;
                } else {
                    std::swap(prow, row);
                    std::swap(pmm, mrow);
                }
            }
            // prow now holds the final needle row
            int32_t score = 0;
            for (int64_t j = 1; j <= m; ++j)
                if (prow[j] > score) score = prow[j];
            int64_t ec = wstart;
            if (score > 0) {
                for (int64_t j = 1; j <= m; ++j)
                    if (prow[j] == score) {
                        ec = wstart + j - 1;  // byte_off is absolute
                        break;
                    }
            }
            if (ec > 0xFFFF) ec = 0xFFFF;
            if (want_idx && score > 0) {
                icnt_out[r] = walk_indices(
                    Hf.data(), Mf.data(), n, m, score, max_typos,
                    nullptr, nullptr, wstart, idx_out + r * icap, icap);
            }
            if (is_exact) score = sat_add16(score, exact_b);
            score_out[r] = score;
            exact_out[r] = is_exact;
            end_col_out[r] = (int32_t)ec;
        }
    }
}

// Unicode twin of host_match_batch: units are codepoints (UTF-32 rows),
// the prefilter and SW run per unit with UTF-8 byte context derived
// in-pass (same formulas as pack_rows_u32), and the greedy fallback runs
// per BYTE on the raw UTF-8 rows with byte-level needle pairs — exactly
// the oracle's split (prefilter/SW: oracle/tokenize.py units; greedy:
// oracle/greedy.py bytes; reference: src/smith_waterman/greedy.rs is
// byte-level even for unicode needles). Window tokenization semantics
// (oracle/tokenize.py lines 115-140, valid UTF-8): the start-1 trim byte
// is either a whole ASCII scalar (joins the window, fresh -1 context) or
// the last byte of a multi-byte scalar (skipped, becomes the first
// window unit's bonus context).
void host_match_batch_u32(
    const uint8_t* joined, const int64_t* bstarts,      // UTF-8 rows
    const uint32_t* joined32, const int64_t* ustarts,   // UTF-32 rows
    const int64_t* rows,                                // optional selection
    int64_t R,
    const int32_t* orig, const int32_t* flip, int64_t n,       // unit pairs
    const int32_t* orig_b, const int32_t* flip_b, int64_t nb,  // byte pairs
    const int32_t* scoring, int64_t max_typos,
    int64_t dp_cap, int64_t min_len,
    const uint8_t* needle_bytes, int64_t needle_len,
    uint8_t* matched_out, int32_t* score_out,
    uint8_t* exact_out, int32_t* end_col_out,
    int32_t* idx_out, int32_t* icnt_out, int64_t icap) {
    const int32_t ms = scoring[0], mm_pen = scoring[1];
    const int32_t gap_open = scoring[2], gap_ext = scoring[3];
    const int32_t prefix_b = scoring[4], cap_b = scoring[5];
    const int32_t case_b = scoring[6], exact_b = scoring[7];
    const int32_t delim_b = scoring[8];
    const int32_t goe = sat_sub16(gap_open, gap_ext);
    const int64_t T = max_typos;
    const bool want_idx = idx_out != nullptr;

#pragma omp parallel
    {
        std::vector<int32_t> h0((size_t)dp_cap + 1), h1((size_t)dp_cap + 1);
        std::vector<uint8_t> m0((size_t)dp_cap + 1), m1((size_t)dp_cap + 1);
        std::vector<int32_t> bonus((size_t)dp_cap);
        std::vector<int64_t> f, nf;
        // per-unit byte context for the current row (grows to row size)
        std::vector<int32_t> ufirst, ulast, uoff, ulen;
        std::vector<int32_t> Hf;
        std::vector<uint8_t> Mf;
        std::vector<int64_t> gidx;
        if (want_idx) {
            Hf.resize((size_t)(n + 1) * (dp_cap + 1));
            Mf.resize((size_t)(n + 1) * (dp_cap + 1));
            gidx.reserve((size_t)nb);
        }

#pragma omp for schedule(dynamic, 8)
        for (int64_t r = 0; r < R; ++r) {
            matched_out[r] = 0;
            score_out[r] = 0;
            exact_out[r] = 0;
            end_col_out[r] = 0;
            if (want_idx) icnt_out[r] = 0;
            const int64_t src = rows ? rows[r] : r;
            const uint8_t* row_b = joined + bstarts[src];
            const int64_t len_b = bstarts[src + 1] - bstarts[src];
            const uint32_t* cp = joined32 + ustarts[src];
            const int64_t mu = ustarts[src + 1] - ustarts[src];
            if (len_b < min_len) continue;

            // -- byte context per unit (pack_rows_u32 formulas) ---------
            if ((int64_t)ufirst.size() < mu) {
                ufirst.resize((size_t)mu);
                ulast.resize((size_t)mu);
                uoff.resize((size_t)mu);
                ulen.resize((size_t)mu);
            }
            {
                int32_t off = 0;
                for (int64_t k = 0; k < mu; ++k) {
                    const uint32_t c = cp[k];
                    int32_t l, fb, lb;
                    if (c < 0x80) {
                        l = 1; fb = (int32_t)c; lb = (int32_t)c;
                    } else if (c < 0x800) {
                        l = 2; fb = 0xC0 | (int32_t)(c >> 6);
                        lb = 0x80 | (int32_t)(c & 0x3F);
                    } else if (c < 0x10000) {
                        l = 3; fb = 0xE0 | (int32_t)(c >> 12);
                        lb = 0x80 | (int32_t)(c & 0x3F);
                    } else {
                        l = 4; fb = 0xF0 | (int32_t)(c >> 18);
                        lb = 0x80 | (int32_t)(c & 0x3F);
                    }
                    ufirst[(size_t)k] = fb;
                    ulast[(size_t)k] = lb;
                    uoff[(size_t)k] = off;
                    ulen[(size_t)k] = l;
                    off += l;
                }
            }

            // -- prefilter window over units ----------------------------
            int64_t start = 0, end = len_b;
            if (T >= 0) {
                if (n <= T) {
                } else if (mu == 0) {
                    continue;
                } else if (T == 0) {
                    int64_t pos = -1, first_pos = -1;
                    bool ok = true;
                    for (int64_t k = 0; k < n; ++k) {
                        int64_t nxt = -1;
                        for (int64_t j = pos + 1; j < mu; ++j) {
                            if ((int32_t)cp[j] == orig[k] ||
                                (int32_t)cp[j] == flip[k]) {
                                nxt = j;
                                break;
                            }
                        }
                        if (nxt < 0) { ok = false; break; }
                        if (first_pos < 0) first_pos = nxt;
                        pos = nxt;
                    }
                    if (!ok) continue;
                    int64_t end_unit = pos;
                    for (int64_t j = mu - 1; j >= pos; --j) {
                        if ((int32_t)cp[j] == orig[n - 1] ||
                            (int32_t)cp[j] == flip[n - 1]) {
                            end_unit = j;
                            break;
                        }
                    }
                    start = uoff[(size_t)first_pos];
                    end = uoff[(size_t)end_unit] + ulen[(size_t)end_unit];
                } else {
                    const int64_t INF = INT64_MAX / 2;
                    f.assign((size_t)T + 1, 0);
                    nf.assign((size_t)T + 1, 0);
                    for (int64_t k = 0; k < n; ++k) {
                        for (int64_t t = 0; t <= T; ++t) {
                            int64_t v = INF;
                            if (f[(size_t)t] < INF) {
                                for (int64_t j = f[(size_t)t]; j < mu; ++j) {
                                    if ((int32_t)cp[j] == orig[k] ||
                                        (int32_t)cp[j] == flip[k]) {
                                        v = j + 1;
                                        break;
                                    }
                                }
                            }
                            if (t > 0 && f[(size_t)(t - 1)] < v)
                                v = f[(size_t)(t - 1)];
                            nf[(size_t)t] = v;
                        }
                        f.swap(nf);
                    }
                    if (f[(size_t)T] >= INF) continue;
                    const int64_t kmax = T + 1 < n ? T + 1 : n;
                    for (int64_t j = 0; j < mu; ++j) {
                        bool any = false;
                        for (int64_t k = 0; k < kmax; ++k)
                            if ((int32_t)cp[j] == orig[k] ||
                                (int32_t)cp[j] == flip[k]) {
                                any = true;
                                break;
                            }
                        if (any) { start = uoff[(size_t)j]; break; }
                    }
                    const int64_t first_tail = n - 1 - T;
                    for (int64_t j = mu - 1; j >= 0; --j) {
                        bool any = false;
                        for (int64_t k = first_tail; k < n; ++k)
                            if ((int32_t)cp[j] == orig[k] ||
                                (int32_t)cp[j] == flip[k]) {
                                any = true;
                                break;
                            }
                        if (any) {
                            end = uoff[(size_t)j] + ulen[(size_t)j];
                            break;
                        }
                    }
                }
            }

            const int64_t wstart = start > 0 ? start - 1 : 0;
            const bool include_exact = wstart == 0 && end == len_b;
            const bool include_prefix = wstart == 0;
            matched_out[r] = 1;
            const bool is_exact =
                include_exact && end - wstart == needle_len &&
                std::memcmp(row_b + wstart, needle_bytes,
                            (size_t)needle_len) == 0;

            if (end - wstart > dp_cap) {
                // -- byte-level greedy on the raw UTF-8 window ----------
                const uint8_t* win = row_b + wstart;
                const int64_t m = end - wstart;
                if (nb > m) {
                    end_col_out[r] =
                        wstart > 0xFFFF ? 0xFFFF : (int32_t)wstart;
                    continue;
                }
                int32_t score = 0;
                int64_t hi = 0, last_idx = 0;
                bool deb = false, prev_lower = false, prev_delim = false;
                bool ok = true;
                if (want_idx) gidx.clear();
                for (int64_t k = 0; k < nb; ++k) {
                    const int64_t hstart = hi;
                    const int64_t limit = m - nb + k;
                    bool found = false;
                    while (hi <= limit) {
                        const int32_t h = win[hi];
                        const bool h_digit = h >= 0x30 && h <= 0x39;
                        const bool h_upper = h >= 0x41 && h <= 0x5A;
                        const bool h_lower = h >= 0x61 && h <= 0x7A;
                        const bool h_delim =
                            h <= 127 && !(h_lower || h_upper || h_digit);
                        if (!h_delim) deb = true;
                        if (h != orig_b[k] && h != flip_b[k]) {
                            prev_delim = deb && h_delim;
                            prev_lower = h_lower;
                            ++hi;
                            continue;
                        }
                        score = sat_add16(score, ms);
                        if (hi != hstart && k != 0) {
                            int64_t gap = hi - hstart - 1;
                            if (gap < 0) gap = 0;
                            if (gap > 0xFFFF) gap = 0xFFFF;
                            score = sat_sub16(
                                score,
                                sat_add16(gap_open,
                                          sat_mul16(gap_ext, gap)));
                        }
                        if (h == orig_b[k]) score = sat_add16(score, case_b);
                        if (h_upper && prev_lower)
                            score = sat_add16(score, cap_b);
                        if (include_prefix && hi == 0)
                            score = sat_add16(score, prefix_b);
                        if (prev_delim && !h_delim)
                            score = sat_add16(score, delim_b);
                        prev_delim = deb && h_delim;
                        prev_lower = h_lower;
                        last_idx = hi;
                        if (want_idx) gidx.push_back(hi);
                        ++hi;
                        found = true;
                        break;
                    }
                    if (!found) { ok = false; break; }
                }
                if (!ok) {
                    end_col_out[r] =
                        wstart > 0xFFFF ? 0xFFFF : (int32_t)wstart;
                    continue;
                }
                int64_t ec = last_idx > 0xFFFF ? 0xFFFF : last_idx;
                ec += wstart;
                if (ec > 0xFFFF) ec = 0xFFFF;
                if (is_exact) score = sat_add16(score, exact_b);
                score_out[r] = score;
                exact_out[r] = is_exact;
                end_col_out[r] = (int32_t)ec;
                if (want_idx) {
                    int32_t* out = idx_out + r * icap;
                    int32_t cnt = 0;
                    for (int64_t g = (int64_t)gidx.size() - 1;
                         g >= 0 && cnt < icap; --g)
                        out[cnt++] = (int32_t)(gidx[(size_t)g] + wstart);
                    icnt_out[r] = cnt;
                }
                continue;
            }

            // -- window units + first-unit bonus context ----------------
            // (tokenize window rule: the start-1 byte joins the window as
            // a unit when it is a whole ASCII scalar, else it is the
            // previous multi-byte unit's last byte = the first window
            // unit's bonus context)
            int64_t ws_u = 0;
            int32_t prev0 = -1;
            if (start > 0) {
                // unit with byte_off == start (prefilter returns unit
                // boundaries); find it by scan from the start estimate
                int64_t s_u = 0;
                while (s_u < mu && uoff[(size_t)s_u] != start) ++s_u;
                if (ulen[(size_t)(s_u - 1)] == 1) {
                    ws_u = s_u - 1;
                    prev0 = -1;
                } else {
                    ws_u = s_u;
                    prev0 = ulast[(size_t)(s_u - 1)];
                }
            }
            int64_t we_u = ws_u;
            while (we_u < mu &&
                   uoff[(size_t)we_u] + ulen[(size_t)we_u] <= end)
                ++we_u;  // exclusive
            const int64_t m = we_u - ws_u;
            if (m <= 0 || n == 0) {
                end_col_out[r] = wstart > 0xFFFF ? 0xFFFF : (int32_t)wstart;
                if (is_exact) {
                    score_out[r] = sat_add16(0, exact_b);
                    exact_out[r] = 1;
                }
                continue;
            }

            for (int64_t j = 0; j < m; ++j) {
                const int32_t fb = ufirst[(size_t)(ws_u + j)];
                const int32_t pb =
                    j == 0 ? prev0 : ulast[(size_t)(ws_u + j - 1)];
                int32_t bo = 0;
                if (fb >= 0x41 && fb <= 0x5A && pb >= 0x61 && pb <= 0x7A)
                    bo += cap_b;
                if (is_delim_b(pb) && !is_delim_b(fb)) bo += delim_b;
                if (include_prefix && j == 0) bo += prefix_b;
                bonus[(size_t)j] = bo;
            }
            const int64_t stride = m + 1;
            int32_t* prow = h0.data();
            int32_t* row = h1.data();
            uint8_t* pmm = m0.data();
            uint8_t* mrow = m1.data();
            if (want_idx) {
                prow = Hf.data();
                pmm = Mf.data();
            }
            for (int64_t j = 0; j <= m; ++j) {
                prow[j] = 0;
                pmm[j] = 0;
            }
            for (int64_t i = 1; i <= n; ++i) {
                const int32_t no = orig[i - 1], nfl = flip[i - 1];
                if (want_idx) {
                    row = Hf.data() + (size_t)(i * stride);
                    mrow = Mf.data() + (size_t)(i * stride);
                }
                row[0] = 0;
                mrow[0] = 0;
                for (int64_t j = 1; j <= m; ++j) {
                    const int32_t h = (int32_t)cp[ws_u + j - 1];
                    const bool exact_c = h == no;
                    const bool match = exact_c || h == nfl;
                    mrow[j] = match;
                    int32_t diag = prow[j - 1];
                    if (match)
                        diag = sat_add16(
                            diag, ms + mm_pen + bonus[(size_t)(j - 1)]);
                    diag = sat_sub16(diag, mm_pen);
                    if (exact_c) diag = sat_add16(diag, case_b);
                    int32_t up = sat_sub16(prow[j], gap_ext);
                    if (pmm[j]) up = sat_sub16(up, goe);
                    int32_t left = sat_sub16(
                        row[j - 1], gap_ext + (mrow[j - 1] ? goe : 0));
                    int32_t v = diag > up ? diag : up;
                    row[j] = v > left ? v : left;
                }
                if (want_idx) {
                    prow = row;
                    pmm = mrow;
                } else {
                    std::swap(prow, row);
                    std::swap(pmm, mrow);
                }
            }
            int32_t score = 0;
            for (int64_t j = 1; j <= m; ++j)
                if (prow[j] > score) score = prow[j];
            int64_t ec = wstart;
            if (score > 0) {
                for (int64_t j = 1; j <= m; ++j)
                    if (prow[j] == score) {
                        ec = uoff[(size_t)(ws_u + j - 1)];
                        break;
                    }
            }
            if (ec > 0xFFFF) ec = 0xFFFF;
            if (want_idx && score > 0) {
                icnt_out[r] = walk_indices(
                    Hf.data(), Mf.data(), n, m, score, max_typos,
                    uoff.data() + ws_u, ulen.data() + ws_u, 0,
                    idx_out + r * icap, icap);
            }
            if (is_exact) score = sat_add16(score, exact_b);
            score_out[r] = score;
            exact_out[r] = is_exact;
            end_col_out[r] = (int32_t)ec;
        }
    }
}

// Batched literal matcher over ragged byte rows (OpenMP).
//
// Semantics contract: oracle/literal.py literal_find — exact / prefix /
// suffix / substring contiguous-run matching with the SW bonus schedule
// per unit (reference: src/literal/algo.rs:262-313; substring picks the
// highest-scoring occurrence, earliest on ties). Units are byte
// sequences (1 byte for ASCII, UTF-8 for codepoint units); a case-flip
// variant only matches when its byte length equals the original's, the
// same rule the oracle's slice comparison enforces.
//
// mode: 0 exact, 1 prefix, 2 suffix, 3 substring. Outputs per row:
// matched, score, pos (byte offset of the match start).
void host_literal_batch(const uint8_t* joined, const int64_t* starts,
                        const int64_t* rows, int64_t R,
                        const uint8_t* obytes, const int64_t* ostarts,
                        const uint8_t* fbytes, const int64_t* fstarts,
                        int64_t n_units, int64_t mode,
                        const int32_t* scoring, int64_t needle_len,
                        uint8_t* matched_out, int32_t* score_out,
                        int32_t* pos_out) {
    const int32_t ms = scoring[0];
    const int32_t prefix_b = scoring[4], cap_b = scoring[5];
    const int32_t case_b = scoring[6], exact_b = scoring[7];
    const int32_t delim_b = scoring[8];

    // matches_at: every unit's bytes equal orig or (same-length) flip
    auto matches_at = [&](const uint8_t* hay, int64_t len,
                          int64_t pos) -> bool {
        int64_t k = pos;
        for (int64_t i = 0; i < n_units; ++i) {
            const int64_t os = ostarts[i], ol = ostarts[i + 1] - os;
            if (k + ol > len) return false;
            const int64_t fs = fstarts[i], fl = fstarts[i + 1] - fs;
            bool eq_o = memcmp(hay + k, obytes + os, (size_t)ol) == 0;
            bool eq_f = (fl == ol) &&
                        memcmp(hay + k, fbytes + fs, (size_t)ol) == 0;
            if (!eq_o && !eq_f) return false;
            k += ol;
        }
        return true;
    };
    auto is_letter = [](uint8_t b) {
        return (b >= 0x41 && b <= 0x5A) || (b >= 0x61 && b <= 0x7A);
    };
    auto is_digit = [](uint8_t b) { return b >= 0x30 && b <= 0x39; };
    auto is_delim = [&](uint8_t b) {
        return b <= 127 && !is_letter(b) && !is_digit(b);
    };
    auto score_at = [&](const uint8_t* hay, int64_t len,
                        int64_t pos) -> int32_t {
        int32_t score = 0;
        int64_t start = pos;
        for (int64_t i = 0; i < n_units; ++i) {
            const int64_t os = ostarts[i], ol = ostarts[i + 1] - os;
            int32_t s = ms;
            if (memcmp(hay + start, obytes + os, (size_t)ol) == 0)
                s += case_b;
            if (start == 0) {
                s += prefix_b;
            } else {
                const uint8_t byte = hay[start];
                const uint8_t prev = hay[start - 1];
                if (byte >= 0x41 && byte <= 0x5A && prev >= 0x61 &&
                    prev <= 0x7A)
                    s += cap_b;
                if (is_delim(prev) && !is_delim(byte)) s += delim_b;
            }
            score = sat_add16(score, s);
            start += ol;
        }
        if (pos == 0 && needle_len == len)
            score = sat_add16(score, exact_b);
        return score;
    };

#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < R; ++r) {
        matched_out[r] = 0;
        score_out[r] = 0;
        pos_out[r] = 0;
        const int64_t src = rows ? rows[r] : r;
        const uint8_t* hay = joined + starts[src];
        const int64_t len = starts[src + 1] - starts[src];
        if (len < needle_len || needle_len == 0) continue;
        if (mode == 0) {  // exact
            if (len == needle_len && matches_at(hay, len, 0)) {
                matched_out[r] = 1;
                score_out[r] = score_at(hay, len, 0);
            }
        } else if (mode == 1) {  // prefix
            if (matches_at(hay, len, 0)) {
                matched_out[r] = 1;
                score_out[r] = score_at(hay, len, 0);
            }
        } else if (mode == 2) {  // suffix
            const int64_t pos = len - needle_len;
            if (matches_at(hay, len, pos)) {
                matched_out[r] = 1;
                score_out[r] = score_at(hay, len, pos);
                pos_out[r] = (int32_t)pos;
            }
        } else {  // substring: best score, earliest on ties
            const int64_t o0s = ostarts[0], o0l = ostarts[1] - o0s;
            const int64_t f0s = fstarts[0], f0l = fstarts[1] - f0s;
            const uint8_t ob0 = obytes[o0s];
            const uint8_t fb0 = (f0l == o0l) ? fbytes[f0s] : 0;
            const bool has_f0 = f0l == o0l;
            int32_t best = -1;
            int64_t best_pos = 0;
            for (int64_t pos = 0; pos + needle_len <= len; ++pos) {
                const uint8_t b = hay[pos];
                if (b != ob0 && !(has_f0 && b == fb0)) continue;
                if (!matches_at(hay, len, pos)) continue;
                const int32_t sc = score_at(hay, len, pos);
                if (sc > best) {
                    best = sc;
                    best_pos = pos;
                }
            }
            if (best >= 0) {
                matched_out[r] = 1;
                score_out[r] = best;
                pos_out[r] = (int32_t)best_pos;
            }
        }
    }
}

// Per-row UTF-8 byte counts for a UTF-32 buffer.
void utf8_lengths(const uint32_t* joined, const int64_t* starts, int64_t n,
                  int64_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int64_t b = 0;
        for (int64_t k = starts[i]; k < starts[i + 1]; ++k) {
            uint32_t c = joined[k];
            b += c < 0x80 ? 1 : c < 0x800 ? 2 : c < 0x10000 ? 3 : 4;
        }
        out[i] = b;
    }
}

// OpenMP threads a parallel region of this library uses (reported by
// chip_smoke.py beside its timings).
int64_t native_omp_threads() { return (int64_t)omp_get_max_threads(); }

}  // extern "C"
