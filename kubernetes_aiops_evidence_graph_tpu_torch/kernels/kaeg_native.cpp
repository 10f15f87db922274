// kaeg_native — native runtime kernels for the host-side hot loops.
//
// The reference delegates heavy host work to external servers (Neo4j/JVM,
// Loki/Go, SURVEY.md §2.3); this framework keeps it in-process and native:
//   * scan_logs: the log-pattern scan (LogsCollector's per-line regex loop,
//     reference logs_collector.py:167-192) as a single pass over the raw
//     byte buffer with word-boundary-aware substring matching;
//   * build_csr + khop_reach: depth-limited BFS over the tensorized COO
//     edge lists (the apoc.path.subgraphAll analog, neo4j.py:169-201) for
//     the API graph endpoint at 50k-node scale.
//
// Built with g++ -O3 -shared -fPIC -std=c++17 at first use by
// kernels/_build.py into kernels/_build/ and loaded with ctypes by
// native.py. A failed build or load raises; no caller serves around it.
#include <cstdint>
#include <cstring>
#include <cctype>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Log scanning
// ---------------------------------------------------------------------------

// Category patterns: alternatives separated by '|', categories by '\n'.
// Matching = case-insensitive substring with word-ish boundaries on both
// sides (non-alphanumeric neighbors), mirroring the Python \b regexes.

static inline bool is_word(unsigned char c) {
    return std::isalnum(c) != 0;
}

static bool match_at(const char* hay, int64_t hay_len, int64_t pos,
                     const char* pat, int64_t pat_len, bool boundaries) {
    if (pos + pat_len > hay_len) return false;
    for (int64_t i = 0; i < pat_len; ++i) {
        if (std::tolower((unsigned char)hay[pos + i]) !=
            std::tolower((unsigned char)pat[i])) return false;
    }
    if (boundaries) {
        if (pos > 0 && is_word((unsigned char)hay[pos - 1]) &&
            is_word((unsigned char)pat[0])) return false;
        if (pos + pat_len < hay_len &&
            is_word((unsigned char)hay[pos + pat_len - 1]) &&
            is_word((unsigned char)hay[pos + pat_len])) return false;
    }
    return true;
}

static bool line_matches(const char* line, int64_t len,
                         const char* alts, bool boundaries) {
    const char* p = alts;
    while (*p) {
        const char* end = std::strchr(p, '|');
        int64_t plen = end ? (end - p) : (int64_t)std::strlen(p);
        if (plen > 0 && plen <= len) {
            for (int64_t pos = 0; pos + plen <= len; ++pos) {
                if (match_at(line, len, pos, p, plen, boundaries)) return true;
            }
        }
        if (!end) break;
        p = end + 1;
    }
    return false;
}

// buf: newline-separated log lines. categories: '\n'-separated alternative
// lists (see above). out_counts[cat] = lines matching category.
// out_line_flags: bitmask per line (bit c set when category c matched),
// capped at 64 categories. Returns number of lines scanned.
int64_t scan_logs(const char* buf, int64_t buf_len,
                  const char* categories, int32_t num_categories,
                  int32_t boundaries_mask,
                  int64_t* out_counts, uint64_t* out_line_flags,
                  int64_t max_lines) {
    // split category table
    std::vector<const char*> cat_ptr;
    std::vector<std::string> cat_store;
    {
        const char* p = categories;
        while (*p && (int32_t)cat_store.size() < num_categories) {
            const char* end = std::strchr(p, '\n');
            size_t len = end ? (size_t)(end - p) : std::strlen(p);
            cat_store.emplace_back(p, len);
            if (!end) break;
            p = end + 1;
        }
        for (auto& s : cat_store) cat_ptr.push_back(s.c_str());
    }
    for (int32_t c = 0; c < num_categories; ++c) out_counts[c] = 0;

    // Every '\n'-separated segment is one line, INCLUDING empty ones, so
    // flag indices stay aligned with the caller's line list.
    int64_t line_idx = 0;
    int64_t start = 0;
    for (int64_t i = 0; i <= buf_len && line_idx < max_lines; ++i) {
        if (i == buf_len || buf[i] == '\n') {
            int64_t len = i - start;
            uint64_t flags = 0;
            if (len > 0) {
                for (size_t c = 0; c < cat_ptr.size(); ++c) {
                    bool b = (boundaries_mask >> c) & 1;
                    if (line_matches(buf + start, len, cat_ptr[c], b)) {
                        out_counts[c]++;
                        if (c < 64) flags |= (1ULL << c);
                    }
                }
            }
            if (out_line_flags) out_line_flags[line_idx] = flags;
            line_idx++;
            start = i + 1;
        }
    }
    return line_idx;
}

// ---------------------------------------------------------------------------
// Graph BFS over COO edges
// ---------------------------------------------------------------------------

// reach[node] = 1 for nodes within `hops` of seed (seed included).
// Edges are directed as given; pass both directions for undirected reach.
void khop_reach(const int32_t* src, const int32_t* dst, int64_t num_edges,
                int32_t num_nodes, int32_t seed, int32_t hops,
                uint8_t* reach /* [num_nodes] zeroed by caller */) {
    // build CSR
    std::vector<int64_t> offsets(num_nodes + 1, 0);
    for (int64_t e = 0; e < num_edges; ++e) offsets[src[e] + 1]++;
    for (int32_t n = 0; n < num_nodes; ++n) offsets[n + 1] += offsets[n];
    std::vector<int32_t> nbr(num_edges);
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t e = 0; e < num_edges; ++e) nbr[cursor[src[e]]++] = dst[e];

    std::vector<int32_t> frontier{seed};
    reach[seed] = 1;
    for (int32_t h = 0; h < hops && !frontier.empty(); ++h) {
        std::vector<int32_t> next;
        next.reserve(frontier.size() * 2);
        for (int32_t u : frontier) {
            for (int64_t k = offsets[u]; k < offsets[u + 1]; ++k) {
                int32_t v = nbr[k];
                if (!reach[v]) {
                    reach[v] = 1;
                    next.push_back(v);
                }
            }
        }
        frontier.swap(next);
    }
}

}  // extern "C"
